"""Tracing: spans whose root context is checkpointed into object status
(the port's copy of the reference's ``observability/tracing.py``).

A Task's root span context is persisted in its status at initialization
and read back on every reconcile, so one logical trace spans many
reconciles (and, with a shared store, many processes). ``Tracer`` mints
W3C-style hex ids, keeps finished spans in a ring buffer for inspection,
and exports OTLP-JSON over HTTP only if ``OTEL_EXPORTER_OTLP_ENDPOINT`` is
set (a silent no-op otherwise).
"""

from __future__ import annotations

import collections
import json
import os
import queue
import secrets
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Optional

from ..api.resources import SpanContext


def new_trace_id() -> str:
    return secrets.token_hex(16)


def new_span_id() -> str:
    return secrets.token_hex(8)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_span_id: str = ""
    start_time: float = field(default_factory=time.time)
    end_time: Optional[float] = None
    attributes: dict[str, Any] = field(default_factory=dict)
    status: str = "OK"

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def context(self) -> SpanContext:
        return SpanContext(trace_id=self.trace_id, span_id=self.span_id)

    @property
    def duration(self) -> float:
        return (self.end_time or time.time()) - self.start_time


class Tracer:
    def __init__(self, max_finished: int = 4096, endpoint: Optional[str] = None):
        # endpoint: None = use env (no-op if unset); "" = explicitly disabled
        if endpoint is None:
            endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT", "")
        self.endpoint = endpoint
        self.finished: collections.deque[Span] = collections.deque(maxlen=max_finished)
        self._lock = threading.Lock()
        # exports run on a dedicated daemon thread so span ends never block
        # the asyncio reconcile loop
        self._export_queue: "queue.Queue[Optional[Span]]" = queue.Queue(maxsize=1024)
        self._export_thread: Optional[threading.Thread] = None

    def _ensure_export_thread(self) -> None:
        if self._export_thread is None or not self._export_thread.is_alive():
            self._export_thread = threading.Thread(
                target=self._export_loop, name="otlp-export", daemon=True
            )
            self._export_thread.start()

    def _export_loop(self) -> None:
        while True:
            span = self._export_queue.get()
            if span is None:
                return
            self._export(span)

    def start_span(
        self,
        name: str,
        parent: Optional[SpanContext] = None,
        attributes: dict[str, Any] | None = None,
    ) -> Span:
        if parent is not None and parent.trace_id:
            trace_id, parent_span_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_span_id = new_trace_id(), ""
        return Span(
            name=name,
            trace_id=trace_id,
            span_id=new_span_id(),
            parent_span_id=parent_span_id,
            attributes=dict(attributes or {}),
        )

    def end_span(
        self, span: Span, status: str = "OK", end_time: Optional[float] = None
    ) -> None:
        """Finish ``span`` (now, or at an explicit historical ``end_time``
        for a span reconstructed after the fact)."""
        span.end_time = time.time() if end_time is None else end_time
        span.status = status
        with self._lock:
            self.finished.append(span)
        if self.endpoint:
            self._ensure_export_thread()
            try:
                self._export_queue.put_nowait(span)
            except queue.Full:
                pass  # drop rather than block

    def _export(self, span: Span) -> None:
        """Best-effort OTLP/JSON export; failures are silent (no-op fallback)."""
        body = {
            "resourceSpans": [
                {
                    "resource": {
                        "attributes": [
                            {"key": "service.name", "value": {"stringValue": "acp-tpu"}}
                        ]
                    },
                    "scopeSpans": [
                        {
                            "spans": [
                                {
                                    "traceId": span.trace_id,
                                    "spanId": span.span_id,
                                    "parentSpanId": span.parent_span_id,
                                    "name": span.name,
                                    "startTimeUnixNano": int(span.start_time * 1e9),
                                    "endTimeUnixNano": int((span.end_time or time.time()) * 1e9),
                                    "attributes": [
                                        {"key": k, "value": {"stringValue": str(v)}}
                                        for k, v in span.attributes.items()
                                    ],
                                }
                            ]
                        }
                    ],
                }
            ]
        }
        try:
            req = urllib.request.Request(
                self.endpoint.rstrip("/") + "/v1/traces",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"},
            )
            urllib.request.urlopen(req, timeout=2.0)
        except Exception:
            pass

    def spans_for_trace(self, trace_id: str) -> list[Span]:
        with self._lock:
            return [s for s in self.finished if s.trace_id == trace_id]


NOOP_TRACER = Tracer(endpoint="")  # explicitly disabled, ignores env
