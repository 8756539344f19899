"""Tracing and the metrics registry. The flight recorder, the dispatch
profiler, trace export and the OTLP metrics push are ROADMAP A.11."""

from .metrics import REGISTRY, Registry
from .tracing import NOOP_TRACER, Span, Tracer, new_span_id, new_trace_id

__all__ = ["REGISTRY", "Registry", "NOOP_TRACER", "Span", "Tracer", "new_span_id",
           "new_trace_id"]
