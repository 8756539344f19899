"""Tracing, the metrics registry and its OTLP push, the engine's flight
recorder, its dispatch profiler and trace export."""

from .flight import FlightRecorder, attribute_phases, phase_summaries
from .metrics import REGISTRY, Registry
from .otel_metrics import MetricsExporter
from .profiler import WASTE_CAUSES, DispatchProfiler
from .trace_export import TRACE_VERSION, export_trace, validate_trace
from .tracing import NOOP_TRACER, Span, Tracer, new_span_id, new_trace_id

__all__ = ["REGISTRY", "Registry", "NOOP_TRACER", "Span", "Tracer", "new_span_id",
           "new_trace_id", "FlightRecorder", "attribute_phases", "phase_summaries",
           "MetricsExporter", "DispatchProfiler", "WASTE_CAUSES", "TRACE_VERSION",
           "export_trace", "validate_trace"]
