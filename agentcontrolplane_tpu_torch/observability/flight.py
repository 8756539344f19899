"""Engine flight recorder: a ring buffer of the scheduler's decisions, per
request timelines, phase attribution and crash dumps (the port's copy of
the reference's ``observability/flight.py``).

- ``record(kind, rid=..., slot=..., **detail)`` appends one structured
  event, stamped with ``time.monotonic()`` and a sequence number, to a
  bounded deque. The engine thread records most events; ``submit`` and
  shed events come from caller threads, so an append takes one short lock.
  Events are at dispatch granularity, never per token. ``ACP_FLIGHT=0``
  (or ``enabled=False``) reduces ``record`` to one bool branch.
- Events that carry a ``rid`` are also indexed by request, so
  ``timeline(rid)`` replays one request's decisions after the global
  window rolled past them; finished timelines stay in a small LRU.
- ``attribute_phases`` derives the ``queue_wait`` / ``prefill`` /
  ``decode`` / ``preempt_stall`` / ``tool_overlap_hidden`` /
  ``host_stall`` windows from one request's events; ``finish`` exports
  them as ``acp_engine_phase_seconds{phase=...}`` histograms and, when a
  tracer and the request's trace context are set, as child spans under
  the Task's trace (``observability/tracing.py``).
- ``dump_crash`` writes the last events, ``Engine.stats()`` and the page
  allocator's snapshot to a JSON file under ``$ACP_FLIGHT_DUMP_DIR``
  (unset: no dump) right before the engine loop's crash handling.

Reads (``events`` / ``timeline`` / ``timeline_doc`` / ``stats``) run on
REST threads and take the same lock as ``record``; server code goes
through them and never reads the recorder's private fields.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Any, Optional

from .metrics import REGISTRY

log = logging.getLogger("acp_torch.flight")

DEFAULT_CAPACITY = 4096
PER_REQUEST_CAP = 512  # events indexed per request (timeline bound)
FINISHED_TIMELINES = 64  # finished request timelines kept for /timeline
# trace export (observability/trace_export.py) replays finished timelines;
# replay-scale runs can finish more requests than the default LRU holds, so
# the cap is env-tunable and evictions are COUNTED (stats()/trace docs flag
# an incomplete export instead of silently truncating it)

# the phase vocabulary exported as acp_engine_phase_seconds{phase=...}
PHASES = (
    "queue_wait", "prefill", "decode", "preempt_stall",
    "tool_overlap_hidden", "host_stall",
)

# event kinds that carry a rid and mark lifecycle edges (documented in
# the reference's docs/observability.md):
#   submit shed admit prefill_chunk prefill_done decode_block spec_verify
#   preempt park adopt park_release tool_call expire cancel finish
#   swap_out swap_in prefix_share invariant_violation crash restart
#   cold_compile (a program's first dispatch after prewarm; see
#   observability/profiler.py)


def _trace_ids(trace) -> Optional[tuple[str, str]]:
    """(trace_id, parent_span_id) from a SpanContext-like object or dict;
    None when there is nothing to parent spans under."""
    if trace is None:
        return None
    if isinstance(trace, dict):
        tid, sid = trace.get("trace_id", ""), trace.get("span_id", "")
    else:
        tid = getattr(trace, "trace_id", "")
        sid = getattr(trace, "span_id", "")
    return (tid, sid) if tid else None


def attribute_phases(
    events: list[dict],
) -> tuple[dict[str, float], list[tuple[str, float, float]]]:
    """Derive per-phase durations AND windows from one request's rendered
    event list. Returns ``(durations, windows)`` where windows are
    ``(phase, t0, t1)`` monotonic intervals (preempt stalls and tool-overlap
    windows may repeat). Durations sum (excluding the decode-overlapping
    ``tool_overlap_hidden``) to ~end-to-end latency:

    - ``queue_wait``     submit -> first admission (slot + pages reserved)
    - ``prefill``        first admission -> first sampled token
    - ``preempt_stall``  each preemption -> the resume's first token (the
      latency the request lost to pool pressure: requeue wait + re-prefill)
    - ``decode``         first token -> finish, minus the preempt stalls
    - ``tool_overlap_hidden``  per early-emitted tool call, emit -> finish
      (the execution window overlap hid inside decode; informational — it
      overlaps ``decode`` rather than extending the total)
    - ``host_stall``  per KV swap event, the engine-thread seconds spent
      blocked inside host<->HBM copies for this request (``stall_s`` on
      ``swap_out``/``swap_in`` events); informational — it overlaps the
      phase the swap ran inside (prefill or preempt_stall) rather than
      extending the total

    Tolerant of partial histories: a request that was shed/expired/crashed
    before some edge simply lacks the later phases."""
    t_submit = t_admit = t_first = t_end = None
    stalls: list[tuple[float, float]] = []
    tool_marks: list[float] = []
    host_stalls: list[tuple[float, float]] = []
    pending_preempt: Optional[float] = None
    for ev in events:
        kind, t = ev["kind"], ev["t"]
        if kind == "submit" and t_submit is None:
            t_submit = t
        elif kind == "admit" and t_admit is None:
            t_admit = t
        elif kind == "prefill_done":
            if t_first is None:
                t_first = t
            if pending_preempt is not None:
                stalls.append((pending_preempt, t))
                pending_preempt = None
        elif kind == "preempt":
            if pending_preempt is None:
                pending_preempt = t
        elif kind == "tool_call":
            tool_marks.append(t)
        elif kind in ("swap_out", "swap_in"):
            stall = float((ev.get("detail") or {}).get("stall_s") or 0.0)
            if stall > 0:
                host_stalls.append((t - stall, t))
        elif kind in ("finish", "expire", "cancel", "shed"):
            t_end = t
    if not events:
        return {}, []
    if t_end is None:
        t_end = events[-1]["t"]
    if pending_preempt is not None:  # preempted, never resumed before end
        stalls.append((pending_preempt, t_end))
    windows: list[tuple[str, float, float]] = []
    if t_submit is not None and t_admit is not None and t_admit > t_submit:
        windows.append(("queue_wait", t_submit, t_admit))
    if t_admit is not None and t_first is not None and t_first > t_admit:
        windows.append(("prefill", t_admit, t_first))
    # stalls are carved out of whichever phase window contains them: a
    # mid-prefill preemption (preempt before the first token) closes at
    # the FIRST prefill_done and lies inside the prefill window; a
    # mid-decode preemption closes at a later resume (or the end) and
    # lies inside decode. Subtracting from the wrong side would zero
    # decode and double-count prefill for mid-prefill victims.
    pre_stall = post_stall = 0.0
    for a, b in stalls:
        if b > a:
            windows.append(("preempt_stall", a, b))
            if t_first is not None and a < t_first:
                pre_stall += b - a
            else:
                post_stall += b - a
    if t_first is not None and t_end > t_first:
        windows.append(("decode", t_first, t_end))
    for tm in tool_marks:
        if t_end > tm:
            windows.append(("tool_overlap_hidden", tm, t_end))
    for a, b in host_stalls:
        if b > a:
            windows.append(("host_stall", a, b))
    durations: dict[str, float] = {}
    for phase, a, b in windows:
        durations[phase] = durations.get(phase, 0.0) + (b - a)
    if "prefill" in durations:
        durations["prefill"] = max(0.0, durations["prefill"] - pre_stall)
    if "decode" in durations:
        durations["decode"] = max(0.0, durations["decode"] - post_stall)
    return durations, windows


class FlightRecorder:
    """Fixed-size, always-on event window over the engine's decisions.

    One recorder per engine (``engine.flight``). ``tracer`` (optional, wired by the operator) turns
    finished requests' phase windows into OTLP child spans."""

    def __init__(
        self,
        capacity: Optional[int] = None,
        enabled: Optional[bool] = None,
        per_request_cap: int = PER_REQUEST_CAP,
        finished_timelines: Optional[int] = None,
    ):
        if capacity is None:
            capacity = int(os.environ.get("ACP_FLIGHT_EVENTS", str(DEFAULT_CAPACITY)))
        if finished_timelines is None:
            finished_timelines = int(
                os.environ.get("ACP_FLIGHT_TIMELINES", str(FINISHED_TIMELINES))
            )
        if enabled is None:
            enabled = os.environ.get("ACP_FLIGHT", "1") not in ("", "0")
        self.enabled = bool(enabled)
        self.capacity = max(16, int(capacity))
        self.per_request_cap = max(8, int(per_request_cap))
        # OTLP linkage: a tracing.Tracer (or None). Assigned post-init by
        # whoever owns a tracer (Operator.start); plain attribute replacement.
        self.tracer = None
        self._lock = threading.Lock()
        self._events: "collections.deque[tuple]" = collections.deque(
            maxlen=self.capacity
        )
        self._seq = 0
        self._recorded = 0  # total ever recorded (window may have dropped)
        self._by_rid: dict[str, list] = {}  # live request -> its events
        self._truncated_rids: set[str] = set()  # per-request cap hit
        self._done: "collections.OrderedDict[str, list]" = collections.OrderedDict()
        self._done_cap = max(1, int(finished_timelines))
        self._evicted_timelines = 0  # finished timelines aged out of the LRU
        # monotonic -> wall clock, for span export and dump timestamps
        self._mono_to_wall = time.time() - time.monotonic()

    # -- write side (engine thread + submit threads) ----------------------

    def record(self, kind: str, rid: Optional[str] = None, slot: int = -1, **detail) -> None:
        """Append one event. Lock-cheap; safe from any thread."""
        if not self.enabled:
            return
        t = time.monotonic()
        with self._lock:
            self._seq += 1
            ev = (self._seq, t, kind, rid, slot, detail or None)
            self._events.append(ev)
            self._recorded += 1
            if rid is not None:
                lst = self._by_rid.get(rid)
                if lst is None:
                    lst = self._by_rid[rid] = []
                if len(lst) < self.per_request_cap:
                    lst.append(ev)
                elif rid not in self._truncated_rids:
                    self._truncated_rids.add(rid)

    def finish(
        self,
        rid: str,
        reason: str,
        slot: int = -1,
        trace=None,
        **detail,
    ) -> dict[str, float]:
        """Record the request's terminal event, derive its phase
        attribution, export ``acp_engine_phase_seconds`` histograms (and
        OTLP child spans when a tracer + trace context are present), and
        retire the timeline into the finished LRU. Returns the phase
        durations (seconds). Engine-thread."""
        if not self.enabled:
            return {}
        self.record("finish", rid=rid, slot=slot, reason=reason, **detail)
        with self._lock:
            events = self._by_rid.pop(rid, None)
            truncated = rid in self._truncated_rids
            self._truncated_rids.discard(rid)
            if events is not None:
                self._retire_locked(rid, events)
        if not events:
            return {}
        rendered = [self._render(e) for e in events]
        durations, windows = attribute_phases(rendered)
        for phase, dur in durations.items():
            REGISTRY.observe(
                "acp_engine_phase_seconds",
                dur,
                labels={"phase": phase},
                help="per-request engine phase latency attribution derived "
                "from the flight recorder (queue_wait | prefill | decode | "
                "preempt_stall | tool_overlap_hidden | host_stall)",
            )
        if truncated:
            log.debug("flight timeline for rid %s truncated at %d events",
                      rid, self.per_request_cap)
        self._export_spans(rid, windows, trace)
        return durations

    def _retire_locked(self, rid: str, events: list) -> None:
        """Move a live timeline into the finished LRU (hold ``_lock``). A
        rid retired twice (a terminal race recording one more event after
        the first retire) EXTENDS its finished timeline rather than
        clobbering it."""
        prior = self._done.pop(rid, None)
        self._done[rid] = (prior + events) if prior else events
        while len(self._done) > self._done_cap:
            self._done.popitem(last=False)
            self._evicted_timelines += 1

    def discard(self, rid: str) -> None:
        """Retire a timeline without phase export (shed before admission,
        follower replays, bulk drains)."""
        with self._lock:
            events = self._by_rid.pop(rid, None)
            self._truncated_rids.discard(rid)
            if events:
                self._retire_locked(rid, events)

    def discard_live(self) -> None:
        """Drop every live timeline (engine thread exit / crash drain) —
        the global window keeps the raw events for the crash dump."""
        with self._lock:
            self._by_rid.clear()
            self._truncated_rids.clear()

    # -- span export ------------------------------------------------------

    def _export_spans(self, rid: str, windows, trace) -> None:
        tracer = self.tracer
        ids = _trace_ids(trace)
        if tracer is None or ids is None or not windows:
            return
        trace_id, parent_id = ids
        off = self._mono_to_wall
        try:
            from .tracing import Span, new_span_id

            for phase, a, b in windows:
                span = Span(
                    name=f"engine.{phase}",
                    trace_id=trace_id,
                    span_id=new_span_id(),
                    parent_span_id=parent_id,
                    start_time=a + off,
                    attributes={"request_id": rid, "phase": phase},
                )
                tracer.end_span(span, end_time=b + off)
        except Exception:  # tracing must never take the engine down
            log.exception("flight span export failed for rid %s", rid)

    # -- read side (REST scrape threads) ----------------------------------

    @staticmethod
    def _render(ev: tuple) -> dict[str, Any]:  # cross-thread (pure)
        seq, t, kind, rid, slot, detail = ev
        out: dict[str, Any] = {"seq": seq, "t": round(t, 6), "kind": kind}
        if rid is not None:
            out["rid"] = rid
        if slot >= 0:
            out["slot"] = slot
        if detail:
            out["detail"] = detail
        return out

    def events(  # cross-thread
        self,
        last: int = 200,
        kind: Optional[str] = None,
        rid: Optional[str] = None,
    ) -> list[dict[str, Any]]:
        """The newest ``last`` window events (oldest first), optionally
        filtered by kind and/or rid."""
        with self._lock:
            evs = list(self._events)
        if kind is not None:
            evs = [e for e in evs if e[2] == kind]
        if rid is not None:
            evs = [e for e in evs if e[3] == rid]
        if last > 0:
            evs = evs[-last:]
        return [self._render(e) for e in evs]

    def timeline(self, rid: str) -> Optional[list[dict[str, Any]]]:  # cross-thread
        """One request's full event sequence (live or recently finished);
        None when the request is unknown (never recorded, or its timeline
        aged out of the finished LRU)."""
        with self._lock:
            lst = self._by_rid.get(rid)
            if lst is None:
                lst = self._done.get(rid)
            lst = list(lst) if lst is not None else None
        if lst is None:
            return None
        return [self._render(e) for e in lst]

    def timeline_doc(self, rid: str) -> Optional[dict[str, Any]]:  # cross-thread
        """Timeline + phase attribution, the /v1/requests/{id}/timeline
        payload: events with window-relative offsets, per-phase durations,
        and the end-to-end total they sum to."""
        events = self.timeline(rid)
        if events is None:
            return None
        durations, windows = attribute_phases(events)
        t0 = events[0]["t"] if events else 0.0
        doc = {
            "request_id": rid,
            "events": [{**e, "t_rel": round(e["t"] - t0, 6)} for e in events],
            "phases": {k: round(v, 6) for k, v in durations.items()},
            "phase_windows": [
                {"phase": p, "start_rel": round(a - t0, 6), "end_rel": round(b - t0, 6)}
                for p, a, b in windows
            ],
            "total_s": round(events[-1]["t"] - t0, 6) if events else 0.0,
        }
        plan = _rate_plan_summary(events)
        if plan is not None:
            doc["rate_plan"] = plan
        return doc

    def timelines(self) -> dict[str, list[dict[str, Any]]]:  # cross-thread
        """Every queryable per-request timeline (finished LRU first, then
        live), rendered — the trace-export read surface. Timelines survive
        the global event window rolling (``_by_rid``/``_done`` are indexed
        separately from the deque); what bounds them is the finished LRU,
        whose evictions ``stats()['evicted_timelines']`` counts."""
        with self._lock:
            snap = [(rid, list(evs)) for rid, evs in self._done.items()]
            snap += [(rid, list(evs)) for rid, evs in self._by_rid.items()]
        return {rid: [self._render(e) for e in evs] for rid, evs in snap}

    def truncated_rids(self) -> set[str]:  # cross-thread
        """Live rids whose timelines hit ``per_request_cap`` (trace export
        marks these rows rather than exporting a silently short timeline)."""
        with self._lock:
            return set(self._truncated_rids)

    def request_ids(self, last: int = 32) -> list[str]:  # cross-thread
        """Recently finished + live request ids with queryable timelines
        (newest finished last) — the CLI's discovery surface."""
        with self._lock:
            done = list(self._done.keys())
            live = list(self._by_rid.keys())
        return (done + live)[-last:]

    def stats(self) -> dict[str, Any]:  # cross-thread
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self.capacity,
                "window_events": len(self._events),
                "recorded_total": self._recorded,
                "live_requests": len(self._by_rid),
                "finished_timelines": len(self._done),
                "finished_timeline_cap": self._done_cap,
                "evicted_timelines": self._evicted_timelines,
            }

    # -- crash dumps ------------------------------------------------------

    def dump_crash(self, engine, error: BaseException) -> Optional[str]:
        """Snapshot the recent window + engine stats + allocator audit to a
        JSON file under ``$ACP_FLIGHT_DUMP_DIR`` (default off — unset means
        no dump). Called from the engine loop's crash handler BEFORE futures
        are failed; best-effort, never masks the crash. Returns the path."""
        dump_dir = os.environ.get("ACP_FLIGHT_DUMP_DIR", "")
        if not dump_dir:
            return None
        try:
            doc: dict[str, Any] = {
                "error": {"type": type(error).__name__, "message": str(error)},
                "wall_time": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ",
                    time.gmtime(time.monotonic() + self._mono_to_wall),
                ),
                "events": self.events(last=self.capacity),
                "flight": self.stats(),
            }
            try:
                doc["engine_stats"] = engine.stats()
            except Exception as e:  # corrupt state may break stats itself
                doc["engine_stats"] = {"error": repr(e)}
            allocator = getattr(engine, "_allocator", None)
            if allocator is not None:
                try:
                    free_pages, refs = allocator.snapshot()
                    doc["allocator_audit"] = {
                        "free": len(free_pages),
                        "referenced": len(refs),
                        "refcounts": {str(pg): n for pg, n in sorted(refs.items())},
                    }
                except Exception as e:
                    doc["allocator_audit"] = {"error": repr(e)}
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(
                dump_dir, f"flightdump-{int(time.time() * 1e3)}-{os.getpid()}.json"
            )
            with open(path, "w") as f:
                json.dump(doc, f, indent=2)
                f.write("\n")
            log.error("engine crash dump written to %s", path)
            return path
        except Exception:
            log.exception("crash dump failed (crash itself is re-raised)")
            return None


def _rate_plan_summary(events: list) -> Optional[dict[str, Any]]:
    """Quota-vs-actual for one request's chunk-rate plan (engine/planner.py):
    from its ``quota`` projection events (admission + reprojections) and
    the ``prefill_chunk`` dispatches that followed, derive what the
    planner asked for per cycle and what the scheduler actually delivered.
    None when the request carried no rate plan (planner off or no chunked
    prefill)."""
    quotas = [e for e in events if e["kind"] == "quota"]
    if not quotas:
        return None
    chunks = [e for e in events if e["kind"] == "prefill_chunk"]
    tokens = sum(int(e["detail"].get("n", 0)) for e in chunks)
    span = (
        (chunks[-1]["t"] - quotas[0]["t"]) if chunks else 0.0
    )
    return {
        "quota": quotas[-1]["detail"].get("quota"),
        "projections": [
            {
                "reason": e["detail"].get("reason"),
                "quota": e["detail"].get("quota"),
                "tokens_left": e["detail"].get("tokens_left"),
                "seconds_left": e["detail"].get("seconds_left"),
            }
            for e in quotas
        ],
        "reprojections": sum(
            1 for e in quotas if e["detail"].get("reason") != "admit"
        ),
        "chunks_dispatched": len(chunks),
        "chunk_tokens": tokens,
        "prefill_span_s": round(max(0.0, span), 6),
    }


def phase_summaries() -> dict[str, dict[str, float]]:
    """p50/p99 of the windowed ``acp_engine_phase_seconds`` histograms per
    phase — a convenience for status payloads and tests."""
    out: dict[str, dict[str, float]] = {}
    for phase in PHASES:
        labels = {"phase": phase}
        count, window = REGISTRY.series_window("acp_engine_phase_seconds", labels)
        if not count:
            continue
        out[phase] = {
            "count": count,
            "p50": REGISTRY.quantile("acp_engine_phase_seconds", 0.5, labels),
            "p99": REGISTRY.quantile("acp_engine_phase_seconds", 0.99, labels),
        }
    return out


__all__ = [
    "FlightRecorder",
    "attribute_phases",
    "phase_summaries",
    "PHASES",
]
