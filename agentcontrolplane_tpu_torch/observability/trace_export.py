"""Trace export: anonymized workload traces from the flight recorder (the
port's copy of the single-engine part of the reference's
``observability/trace_export.py``).

The flight recorder keeps per-request timelines; this module derives the
workload from them (when requests arrived, their prompt and output
lengths, which persona, that is which prefix-sharing key, each belonged
to, where tool calls landed, which deadlines and cancels were in play) and
writes it as a versioned JSON document the reference's replayer reads.

The trace carries no prompt or output content, only lengths, monotonic
offsets and 16-hex persona fingerprints (a hash of the first 64 prompt
tokens, recorded at ``submit``).

Export never truncates silently: the recorder counts finished timelines
evicted from its LRU (``ACP_FLIGHT_TIMELINES`` raises the cap) and
per-request cap hits, and the document reports both under ``flight`` with
a ``complete`` verdict. The fleet functions (stitching a request's legs
across replicas) come with the fleet (ROADMAP A.12).
"""

from __future__ import annotations

from typing import Any, Optional

TRACE_VERSION = 1

_TERMINAL_KINDS = ("finish", "expire", "cancel", "shed")


def _request_row(events: list[dict]) -> Optional[tuple[float, dict[str, Any]]]:
    """One trace row from one request's rendered timeline: ``(t_submit,
    row)``, or None when the timeline has no submit edge (prewarm legs,
    partial histories that start mid-window)."""
    sub = next((e for e in events if e["kind"] == "submit"), None)
    if sub is None:
        return None
    t_submit = float(sub["t"])
    d = sub.get("detail") or {}
    terminal: Optional[dict] = None
    tool_offsets: list[float] = []
    cancel_at: Optional[float] = None
    for e in events:
        kind = e["kind"]
        if kind in _TERMINAL_KINDS:
            terminal = e
            if kind == "cancel" and cancel_at is None:
                cancel_at = float(e["t"]) - t_submit
        elif kind == "tool_call":
            tool_offsets.append(float(e["t"]) - t_submit)
    td = (terminal.get("detail") or {}) if terminal else {}
    finish = "unknown"
    if terminal is not None:
        finish = str(td.get("reason") or terminal["kind"])
    row: dict[str, Any] = {
        "prompt_tokens": int(d.get("prompt_tokens") or 0),
        "output_tokens": int(td.get("tokens") or 0),
        "persona": str(d.get("key") or ""),
        "finish": finish,
    }
    if d.get("timeout_s") is not None:
        row["deadline_s"] = round(float(d["timeout_s"]), 6)
    if cancel_at is not None:
        row["cancel_after_s"] = round(max(0.0, cancel_at), 6)
    if tool_offsets:
        row["tool_calls"] = [
            {"offset_s": round(max(0.0, o), 6)} for o in tool_offsets
        ]
    return t_submit, row


def _personas(rows: list[dict]) -> dict[str, dict[str, Any]]:
    """Persona mix summary. ``prefix_tokens`` is the replayable shared-
    prefix length: requests sharing a persona key share (at least) their
    first min(64, shortest prompt) tokens — that is what the fingerprint
    hashes — so singleton personas get 0 and shared ones get that floor."""
    by_key: dict[str, list[int]] = {}
    for r in rows:
        key = r.get("persona") or ""
        if key:
            by_key.setdefault(key, []).append(int(r["prompt_tokens"]))
    out: dict[str, dict[str, Any]] = {}
    for key, lens in sorted(by_key.items()):
        shared = min(64, min(lens)) if len(lens) > 1 else 0
        out[key] = {"requests": len(lens), "prefix_tokens": shared}
    return out


def _build_doc(
    timelines: dict[str, list[dict]],
    source: str,
    flight_meta: dict[str, Any],
) -> dict[str, Any]:
    stamped = []
    for rid, events in timelines.items():
        got = _request_row(events)
        if got is not None:
            stamped.append(got)
    stamped.sort(key=lambda p: p[0])
    t0 = stamped[0][0] if stamped else 0.0
    rows = []
    for i, (t_submit, row) in enumerate(stamped):
        rows.append({
            "i": i,
            "offset_s": round(max(0.0, t_submit - t0), 6),
            **row,
        })
    complete = (
        int(flight_meta.get("evicted_timelines") or 0) == 0
        and int(flight_meta.get("truncated_rids") or 0) == 0
        and int(flight_meta.get("missing_legs") or 0) == 0
    )
    return {
        "version": TRACE_VERSION,
        "source": source,
        "anonymized": True,
        "complete": complete,
        "span_s": rows[-1]["offset_s"] if rows else 0.0,
        "requests": rows,
        "personas": _personas(rows),
        "faults": [],
        "flight": flight_meta,
    }


def export_trace(recorder) -> dict[str, Any]:
    """The single-engine trace document: every queryable timeline in
    ``recorder`` (finished LRU + live) becomes one anonymized request row."""
    timelines = recorder.timelines()
    stats = recorder.stats()
    meta = {
        "evicted_timelines": int(stats.get("evicted_timelines") or 0),
        "truncated_rids": len(recorder.truncated_rids()),
        "missing_legs": 0,
    }
    return _build_doc(timelines, "engine", meta)


def validate_trace(doc: Any) -> list[str]:
    """Structural problems with a trace document (empty list = loadable by
    the replayer). A trace is an interchange format, so failures name
    fields, not code."""
    problems: list[str] = []
    if not isinstance(doc, dict):
        return ["trace is not a JSON object"]
    if doc.get("version") != TRACE_VERSION:
        problems.append(
            f"version {doc.get('version')!r} != supported {TRACE_VERSION}"
        )
    reqs = doc.get("requests")
    if not isinstance(reqs, list):
        return problems + ["requests is not a list"]
    last_off = -1.0
    for i, row in enumerate(reqs):
        if not isinstance(row, dict):
            problems.append(f"requests[{i}] is not an object")
            continue
        off = row.get("offset_s")
        if not isinstance(off, (int, float)) or off < 0:
            problems.append(f"requests[{i}].offset_s invalid: {off!r}")
        elif off < last_off:
            problems.append(f"requests[{i}].offset_s decreases ({off} < {last_off})")
        else:
            last_off = float(off)
        for field in ("prompt_tokens", "output_tokens"):
            v = row.get(field)
            if not isinstance(v, int) or v < 0:
                problems.append(f"requests[{i}].{field} invalid: {v!r}")
    return problems


__all__ = ["TRACE_VERSION", "export_trace", "validate_trace"]
