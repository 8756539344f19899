"""Deterministic fault injection (:data:`FAULTS`): the port's copy of the
reference's ``faults.py``, with its own process-wide injector.

``FAULTS`` is a process-wide :class:`FaultInjector`. Every site is guarded
by ``FAULTS.enabled`` (a plain bool, False unless ``$ACP_FAULTS`` is set or
a caller runs ``FAULTS.enable()``), so a disabled site costs one attribute
read. Faults are deterministic: a site is armed by name with explicit
triggers (``times=N`` firings, ``after_steps`` thresholds), never by
chance, so a run that injects a preemption at decode step N replays
byte-identically. The sites carry the reference's names.

Engine sites (``engine/engine.py``):

- ``engine.crash``: raise inside the engine loop (crash recovery).
- ``engine.queue_full``: ``submit()`` sheds as if the admission queue were
  at its cap (503 end to end).
- ``engine.force_preempt``: preempt the policy victim at the first decode
  site where ``decode_steps >= after_steps``.
- ``engine.preempt_mid_prefill``: at the first chunk round where
  ``prefill_chunks >= after_steps``, preempt the mid-prefill slot with the
  most rows written; it re-enters the chunk loop on re-admission.
- ``engine.slow_cycle``: stretch the next ``times=N`` busy scheduler
  cycles by ``delay_s`` each (a sleep in the engine loop). Timing only.
- ``engine.page_pressure``: hold ``pages`` KV pages out of the allocator
  (released when disarmed or reset).
- ``engine.invariant_break``: corrupt a mirror counter (``_parked_count``)
  right before the armed invariant checker runs, so the audit trips end
  to end (the engine crashes with ``InvariantViolation``, callers' futures
  fail, ``ensure_running`` recovers). Inert on a disarmed engine. With
  ``$ACP_FLIGHT_DUMP_DIR`` set the crash also writes the flight
  recorder's dump (``observability/flight.py``).
- ``engine.host_swap_slow``: stretch the next ``times=N`` host-tier swaps
  (a swap-out, or a restore's first chunk) by ``seconds`` each; the stall
  shows as the flight recorder's ``host_stall`` phase. Outputs unchanged.
- ``engine.host_swap_error``: fail the next ``times=N`` host-tier swaps: a
  swap-out lands no entry (the resume recomputes), a restore is abandoned
  and its rows are recomputed by model chunks. Outputs unchanged.
- ``engine.prefetch_error``: abort the next ``times=N`` staged restore
  commits (the prefetch's side-stream copies): the chunk takes the
  blocking copy instead, and a ``prefetch_abort`` event is recorded.
  Outputs unchanged.
- ``engine.spec_mismatch``: for the next ``times=N`` verify passes treat
  every draft token as rejected, so each commits exactly one (still
  correct) token. Outputs unchanged.

Tool-execution sites (``controllers/toolcall.py``):

- ``tool.slow``: stretch the next ``times=N`` MCP executions by
  ``seconds`` each.
- ``tool.error``: fail the next ``times=N`` MCP executions before the call
  reaches the server; the failure joins the conversation as an error tool
  result.

The reference's fleet sites (``fleet.replica_crash``,
``fleet.handoff_error``, ``fleet.route_stale``) come with the fleet
(ROADMAP A.12). This module is stdlib only, so the engine and the
controllers import it without pulling anything else in.
"""

from __future__ import annotations

import os
import threading
from typing import Optional


class FaultInjector:
    """Deterministic, site-keyed fault injection.

    Thread-safe: arm/disarm happen on test threads while ``pop`` /
    ``apply_page_pressure`` run on the engine thread. A site armed with
    ``times=N`` fires at most N times; ``after_steps`` gates firing until
    the caller-supplied ``steps`` context reaches the threshold.
    """

    def __init__(self) -> None:
        self.enabled = bool(os.environ.get("ACP_FAULTS", ""))
        self._lock = threading.Lock()
        self._armed: dict[str, dict] = {}
        # site "engine.page_pressure": pages held per allocator (by id);
        # the allocator reference is kept so reset() can release them
        self._held: dict[int, tuple[object, list[int]]] = {}

    def enable(self) -> None:
        self.enabled = True

    def arm(self, site: str, *, times: int = 1, after_steps: int = 0, **spec) -> None:
        """Arm ``site`` to fire ``times`` times once ``steps >= after_steps``.
        Extra keywords ride along in the spec the call site receives."""
        self.enable()
        with self._lock:
            self._armed[site] = {"times": times, "after_steps": after_steps, **spec}

    def disarm(self, site: str) -> None:
        with self._lock:
            self._armed.pop(site, None)

    def armed(self, site: str) -> bool:
        with self._lock:
            return site in self._armed

    def pop(self, site: str, steps: int = 0, match: Optional[dict] = None):
        """Consume one firing of ``site`` if armed and due; returns the spec
        dict (or None). Call sites guard with ``FAULTS.enabled`` first so
        the disabled path costs one attribute read.

        ``match`` scopes a fault to a specific call site without consuming
        the budget elsewhere: for every key present in BOTH ``match`` and
        the armed spec, the values must be equal or the pop is a no-op
        (e.g. ``fleet.replica_crash`` armed with ``replica="r1"`` fires
        only in the engine whose ``fleet_replica_id`` is ``"r1"``; a spec
        armed without the key fires at any matching site)."""
        with self._lock:
            spec = self._armed.get(site)
            if spec is None or steps < spec["after_steps"]:
                return None
            if match:
                for k, v in match.items():
                    if k in spec and spec[k] != v:
                        return None
            spec["times"] -= 1
            if spec["times"] <= 0:
                del self._armed[site]
            return dict(spec)

    def held_pages(self, allocator) -> list[int]:
        """Pages ``engine.page_pressure`` is holding out of ``allocator``
        — the invariant checker's ownership audit counts them as owned (a
        held page is referenced on purpose, not leaked)."""
        with self._lock:
            ent = self._held.get(id(allocator))
            return list(ent[1]) if ent else []

    def apply_page_pressure(self, allocator) -> None:
        """Converge the pages held from ``allocator`` toward the armed
        ``engine.page_pressure`` spec (``pages=N``; 0/disarmed releases).
        Engine-thread only — the allocator is engine-thread-owned."""
        with self._lock:
            spec = self._armed.get("engine.page_pressure")
            want = int(spec["pages"]) if spec else 0
            _, held = self._held.setdefault(id(allocator), (allocator, []))
            if len(held) < want:
                take = min(want - len(held), allocator.free_count)
                if take:
                    held.extend(allocator.alloc(take))
            elif len(held) > want:
                allocator.free(held[want:])
                del held[want:]

    def reset(self) -> None:
        """Disarm everything and release held pages. Tests call this in
        teardown; safe while engines still run (page release is the same
        allocator mutation the engine thread performs, so only call after
        the engine is stopped or idle)."""
        with self._lock:
            self._armed.clear()
            held, self._held = self._held, {}
        for allocator, pages in held.values():
            if pages:
                allocator.free(pages)
        self.enabled = bool(os.environ.get("ACP_FAULTS", ""))


FAULTS = FaultInjector()
