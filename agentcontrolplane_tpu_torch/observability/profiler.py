"""Per-dispatch program telemetry and the goodput/waste ledger (the port's
copy of the reference's ``observability/profiler.py``).

One :class:`DispatchProfiler` per engine (``engine.profiler``), three
layers:

- **per-program dispatch telemetry**: every dispatch site stamps
  ``t0 = profiler.start()`` and calls ``profiler.record(key, t0, ...)``,
  where ``key`` names the program the way the reference keys its compiled
  programs (``prefill[paged,64x2]``, ``chunk[paged,32x1]``,
  ``decode[paged,4x4]``, ``spec_verify[paged,4x5]``,
  ``megastep[paged,m32x1+d4x4]``, ``swap_gather[2]``, ...). ``record``
  sums host wall time, real and padded token and lane counts, and, for
  every ``sample_every``-th dispatch of a key (and always its first), the
  device-inclusive time: the host waits on a CUDA event recorded after
  the dispatch on the stream that ran it. Each dispatch also lands one
  ``acp_engine_dispatch_seconds{program=}`` observation. ``ACP_PROF=0``
  reduces every hook to one bool branch.
- **first dispatches**: a key's first dispatch is always sampled and its
  wall time kept (``first_wall_ms``). On the card it includes one-time
  costs: the paged walk's ``nvcc`` build at its first use and cuBLAS's
  first call. Once the engine declares prewarm complete
  (:meth:`mark_prewarmed`) a later first dispatch is a ``cold_compile``
  flight event and counts in ``acp_engine_cold_compiles_total``; the
  port has no prewarm yet (ROADMAP A.3), so nothing calls it.
- **goodput/waste accounting**: dispatch sites classify every computed
  token position into exactly one cause via :meth:`account`: ``goodput``
  (prompt rows prefilled into live KV, committed tokens) or a waste cause
  (:data:`WASTE_CAUSES`). :meth:`reclassify` moves counted goodput into a
  waste cause when the engine later discards it (zero-sum, clamped), so
  ``computed == goodput + sum(waste)`` holds by construction; the armed
  invariant checker audits it. Exported as
  ``acp_engine_tokens_computed_total{cause=}`` and the
  ``acp_engine_goodput_ratio`` gauge.

The write side (``record`` / ``account`` / ``reclassify``) runs on the
engine thread; the read side (``stats`` / ``ledger`` / ``publish``) runs on
REST threads and takes the same lock.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Any, Optional

from .metrics import REGISTRY

# every computed token position lands in goodput or exactly one of these
WASTE_CAUSES = (
    "pad_bucket",       # prefill rows padded to the compiled bucket
    "pad_width",        # decode/verify lanes+steps beyond committed tokens
    "spec_rejected",    # draft positions the verify pass rejected
    "preempt_discard",  # KV discarded at preempt/expiry and recomputed
    "swap_recompute",   # host-tier restore failed; preserved KV recomputed
    "dedup_rewind",     # follower rewound past rows its dead leader wrote
    "prewarm",          # synthetic warm-up traffic (compute, no serving)
    "pad_fuse",         # pow2 padding rows the fused megastep adds (the
                        # split path's pow2 DECOMPOSITION has none): the
                        # compute price paid for one-dispatch cycles
)

COLD_EVENTS_KEPT = 32  # recent serving-time cold compiles kept for /perf


def _wait_device(out: Any, stream: Any = None) -> None:
    """Wait until the device has run the work that produced ``out``: a
    CUDA event recorded on ``stream`` (or ``out``'s device's current
    stream) and synchronized. A CPU tensor (or any other value) is
    already computed."""
    if not getattr(out, "is_cuda", False):
        return
    import torch

    ev = torch.cuda.Event()
    ev.record(stream if stream is not None else torch.cuda.current_stream(out.device))
    ev.synchronize()


class _Program:
    """Mutable per-program aggregate (guarded by the profiler lock)."""

    __slots__ = (
        "dispatches", "host_s", "blocked_s", "blocked_samples",
        "real_tokens", "padded_tokens", "real_slots", "padded_slots",
        "first_wall_s", "cold",
    )

    def __init__(self) -> None:
        self.dispatches = 0
        self.host_s = 0.0
        self.blocked_s = 0.0      # sampled dispatch-to-device-done wall time
        self.blocked_samples = 0
        self.real_tokens = 0
        self.padded_tokens = 0
        self.real_slots = 0
        self.padded_slots = 0
        self.first_wall_s = 0.0   # first dispatch (one-time build costs)
        self.cold = False         # first dispatch landed AFTER prewarm


class DispatchProfiler:
    """Per-dispatch program telemetry + cold-compile tracking + goodput
    ledger. One per engine (``engine.profiler``); ``flight`` (optional) receives ``cold_compile``
    events so serving-time compiles appear inline with the scheduler
    decisions that caused them."""

    # A/B caveat: `enabled` is a plain mutable attribute (an A/B run may
    # toggle it on a live engine). A program whose FIRST dispatch lands in
    # a disabled window is never registered, so it would read as a cold
    # compile when re-enabled after mark_prewarmed(): toggle only on warm
    # engines, or re-baseline with a fresh profiler.

    def __init__(
        self,
        flight=None,
        enabled: Optional[bool] = None,
        sample_every: Optional[int] = None,
    ):
        if enabled is None:
            enabled = os.environ.get("ACP_PROF", "1") not in ("", "0")
        if sample_every is None:
            sample_every = int(os.environ.get("ACP_PROF_SAMPLE", "32"))
        self.enabled = bool(enabled)
        self.sample_every = max(1, int(sample_every))
        self._flight = flight
        self._lock = threading.Lock()
        self._programs: dict[str, _Program] = {}
        self._warm = False
        self._cold_serving = 0
        self._cold_events: "collections.deque[dict]" = collections.deque(
            maxlen=COLD_EVENTS_KEPT
        )
        # the goodput/waste ledger: computed == goodput + sum(waste) holds
        # by construction (account() adds both sides; reclassify() is a
        # clamped zero-sum move) — the armed invariant checker audits it
        self._computed = 0
        self._goodput = 0
        self._waste: dict[str, int] = {c: 0 for c in WASTE_CAUSES}
        # registry values pushed so far, so publish() emits deltas and two
        # concurrent publishers can't double-count
        self._pub_tokens: dict[str, int] = {}
        self._pub_prog: dict[tuple[str, str], int] = {}

    # -- write side (engine thread) ---------------------------------------

    def start(self) -> float:
        """Stamp a dispatch about to be issued (0.0 when disabled — the
        matching ``record`` is then skipped by its own guard)."""
        return time.monotonic() if self.enabled else 0.0

    def record(
        self,
        key: str,
        t0: float,
        out: Any = None,
        real_tokens: int = 0,
        padded_tokens: int = 0,
        real_slots: int = 0,
        padded_slots: int = 0,
        stream: Any = None,
    ) -> None:
        """One dispatch of program ``key``: host wall time since ``t0`` plus
        real/padded token and lane counts. ``out`` (a tensor the dispatch
        produced) lets the sampled dispatches, and always a key's first,
        wait until the device has run it, for a device-inclusive time: on
        CUDA the host records an event after the dispatch on ``stream``
        (default: the current stream of ``out``'s device; the prefetch's
        side stream for swap records) and waits on it. On the CPU the ops
        have run when they return, so no wait is needed. The wait changes
        timing only, never values, so profiler on or off is
        byte-identical. What it costs the pipeline: the host stops issuing
        until the stream drains, so the next dispatch's launches are no
        longer hidden behind this one's kernels, once every
        ``sample_every`` dispatches of a key."""
        if not self.enabled or not t0:
            # t0 == 0.0 means start() ran while the profiler was disabled
            # and `enabled` flipped mid-dispatch (an A/B run toggles it
            # from another thread) — a time-since-boot "duration" from the
            # zero stamp would corrupt the program's stats
            return
        host_s = time.monotonic() - t0
        with self._lock:
            p = self._programs.get(key)
            first = p is None
            if first:
                p = self._programs[key] = _Program()
            sample = first or (p.dispatches % self.sample_every == 0)
        blocked_s = None
        if sample and out is not None:
            _wait_device(out, stream)
            blocked_s = time.monotonic() - t0
        cold = False
        wall = blocked_s if blocked_s is not None else host_s
        with self._lock:
            p.dispatches += 1
            p.host_s += host_s
            p.real_tokens += int(real_tokens)
            p.padded_tokens += int(padded_tokens)
            p.real_slots += int(real_slots)
            p.padded_slots += int(padded_slots)
            if blocked_s is not None:
                p.blocked_s += blocked_s
                p.blocked_samples += 1
            if first:
                p.first_wall_s = wall
                if self._warm:
                    p.cold = True
                    self._cold_serving += 1
                    self._cold_events.append(
                        {"program": key, "wall_s": round(wall, 6),
                         "t": round(t0, 6)}
                    )
                    cold = True
        REGISTRY.observe(
            "acp_engine_dispatch_seconds", host_s, labels={"program": key},
            help="host wall time per device dispatch, by compiled program "
            "(kind x bucket/width x batch x layout); sampled legs include "
            "the device wait in the per-program stats",
        )
        if cold:
            REGISTRY.counter_add(
                "acp_engine_cold_compiles_total", 1.0,
                help="first dispatches of a program key after prewarm declared "
                "completion (one-time costs real traffic paid at serving time)",
            )
            if self._flight is not None:
                self._flight.record(
                    "cold_compile", program=key, wall_s=round(wall, 6)
                )

    def account(self, goodput: int = 0, **waste: int) -> None:
        """Classify one dispatch's computed token positions: ``goodput``
        plus any :data:`WASTE_CAUSES` keywords. The computed total is the
        sum of what the caller passes, so ledger conservation holds by
        construction; an unknown cause raises (programming error)."""
        if not self.enabled:
            return
        with self._lock:
            total = int(goodput)
            self._goodput += int(goodput)
            for cause, n in waste.items():
                if cause not in self._waste:
                    raise KeyError(f"unknown waste cause {cause!r}")
                if n:
                    self._waste[cause] += int(n)
                    total += int(n)
            self._computed += total

    def reclassify(self, cause: str, n: int) -> None:
        """Move ``n`` already-goodput token positions into ``cause`` — the
        engine discarded compute it had counted useful (preemption without
        a host swap, a failed restore, a dedup follower rewind). Zero-sum
        and clamped at the available goodput, so conservation survives
        over-estimates (e.g. prefix-cache rows that were never computed in
        this admission)."""
        if not self.enabled or n <= 0:
            return
        if cause not in self._waste:
            raise KeyError(f"unknown waste cause {cause!r}")
        with self._lock:
            n = min(int(n), self._goodput)
            if n <= 0:
                return
            self._goodput -= n
            self._waste[cause] += n

    def mark_prewarmed(self) -> None:
        """Prewarm coverage is complete: every LATER first-dispatch of a
        program key is a serving-time cold compile (flight event +
        ``acp_engine_cold_compiles_total``)."""
        with self._lock:
            self._warm = True

    # -- read side (engine loop per cycle + REST scrape threads) ----------

    def publish(self) -> None:  # cross-thread
        """Push ledger counters (as deltas) and the goodput-ratio gauge to
        the registry. Called per busy cycle by the engine loop and at
        scrape time; safe from any thread (delta bookkeeping happens under
        the profiler lock, so concurrent publishers never double-count)."""
        if not self.enabled:
            return
        with self._lock:
            token_deltas: list[tuple[str, int]] = []
            for cause, n in [("goodput", self._goodput), *self._waste.items()]:
                d = n - self._pub_tokens.get(cause, 0)
                if d:
                    token_deltas.append((cause, d))
                    self._pub_tokens[cause] = n
            prog_deltas: list[tuple[str, str, int]] = []
            for key, p in self._programs.items():
                for kind, n in (("real", p.real_tokens), ("padded", p.padded_tokens)):
                    d = n - self._pub_prog.get((key, kind), 0)
                    if d:
                        prog_deltas.append((key, kind, d))
                        self._pub_prog[(key, kind)] = n
            computed, goodput = self._computed, self._goodput
        for cause, d in token_deltas:
            REGISTRY.counter_add(
                "acp_engine_tokens_computed_total", float(d),
                labels={"cause": cause},
                help="computed token positions by outcome: goodput (live KV "
                "+ committed tokens) vs the waste causes (bucket/width "
                "padding, rejected drafts, preempt-discarded KV, host-swap "
                "recompute, dedup rewinds, prewarm)",
            )
        for key, kind, d in prog_deltas:
            REGISTRY.counter_add(
                "acp_engine_dispatch_tokens_total", float(d),
                labels={"program": key, "kind": kind},
                help="token positions dispatched per compiled program, "
                "split real vs padding (the per-program padding-waste "
                "series behind the goodput accounting)",
            )
        REGISTRY.gauge_set(
            "acp_engine_goodput_ratio",
            (goodput / computed) if computed else 1.0,
            help="goodput token positions / all computed token positions "
            "(1.0 = no padding or discarded compute); see "
            "acp_engine_tokens_computed_total for the waste attribution",
        )

    def ledger(self) -> dict[str, Any]:  # cross-thread
        """Snapshot of the goodput/waste ledger (the invariant checker's
        conservation input): ``computed == goodput + sum(waste.values())``."""
        with self._lock:
            return {
                "computed": self._computed,
                "goodput": self._goodput,
                "waste": dict(self._waste),
            }

    def stats(self) -> dict[str, Any]:  # cross-thread
        """The /v1/engine/perf payload: per-program dispatch stats, the
        cold-compile observatory, and the goodput/waste ledger."""
        self.publish()
        with self._lock:
            programs: dict[str, dict[str, Any]] = {}
            for key, p in sorted(
                self._programs.items(), key=lambda kv: -kv[1].host_s
            ):
                if not p.dispatches:
                    # record() creates the entry, drops the lock for the
                    # sampled device wait, then increments: a scrape
                    # landing in that window skips the half-born program
                    continue
                padded_pct = (
                    round(100.0 * p.padded_tokens / (p.real_tokens + p.padded_tokens), 2)
                    if (p.real_tokens + p.padded_tokens) else 0.0
                )
                programs[key] = {
                    "dispatches": p.dispatches,
                    "host_ms_total": round(p.host_s * 1e3, 3),
                    "host_ms_mean": round(p.host_s / p.dispatches * 1e3, 4),
                    "device_ms_mean": (
                        round(p.blocked_s / p.blocked_samples * 1e3, 4)
                        if p.blocked_samples else None
                    ),
                    "device_samples": p.blocked_samples,
                    "real_tokens": p.real_tokens,
                    "padded_tokens": p.padded_tokens,
                    "padding_pct": padded_pct,
                    "real_slots": p.real_slots,
                    "padded_slots": p.padded_slots,
                    "first_wall_ms": round(p.first_wall_s * 1e3, 3),
                    "cold": p.cold,
                }
            waste = dict(self._waste)
            computed, goodput = self._computed, self._goodput
            doc = {
                "enabled": self.enabled,
                "sample_every": self.sample_every,
                "prewarmed": self._warm,
                "programs": programs,
                "cold_compiles": {
                    "serving": self._cold_serving,
                    "events": list(self._cold_events),
                },
                "goodput": {
                    "computed": computed,
                    "goodput": goodput,
                    "ratio": round(goodput / computed, 4) if computed else 1.0,
                    "waste": waste,
                },
            }
        return doc


__all__ = ["DispatchProfiler", "WASTE_CAUSES"]
