"""OTLP metrics export (the port's copy of the reference's
``observability/otel_metrics.py``).

A daemon thread snapshots the registry every ``interval`` seconds and POSTs
OTLP-JSON to ``$OTEL_EXPORTER_OTLP_ENDPOINT/v1/metrics``. Without the
variable ``start()`` does nothing, and a failed push is logged at debug
level and dropped. Counters map to monotonic cumulative Sums, gauges to
Gauges, and windowed histograms to Summary points with their quantiles.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.request
from typing import Optional

from .metrics import REGISTRY, Registry

log = logging.getLogger("acp_torch.otel")

_NANOS = 1_000_000_000


def _attrs(labels: dict[str, str]) -> list[dict]:
    return [{"key": k, "value": {"stringValue": v}} for k, v in labels.items()]


def _to_otlp(snapshot: list[dict], start_nanos: int, now_nanos: int) -> dict:
    metrics = []
    for m in snapshot:
        if m["type"] == "counter":
            data = {
                "sum": {
                    "aggregationTemporality": 2,  # CUMULATIVE
                    "isMonotonic": True,
                    "dataPoints": [
                        {
                            "attributes": _attrs(s["labels"]),
                            "startTimeUnixNano": str(start_nanos),
                            "timeUnixNano": str(now_nanos),
                            "asDouble": s["value"],
                        }
                        for s in m["series"]
                    ],
                }
            }
        elif m["type"] == "gauge":
            data = {
                "gauge": {
                    "dataPoints": [
                        {
                            "attributes": _attrs(s["labels"]),
                            "timeUnixNano": str(now_nanos),
                            "asDouble": s["value"],
                        }
                        for s in m["series"]
                    ]
                }
            }
        else:  # histogram -> OTLP Summary (windowed quantiles)
            data = {
                "summary": {
                    "dataPoints": [
                        {
                            "attributes": _attrs(s["labels"]),
                            "startTimeUnixNano": str(start_nanos),
                            "timeUnixNano": str(now_nanos),
                            "count": str(s["count"]),
                            "sum": s["sum"],
                            "quantileValues": [
                                {"quantile": q, "value": v}
                                for q, v in s["quantiles"].items()
                            ],
                        }
                        for s in m["series"]
                    ]
                }
            }
        metrics.append({"name": m["name"], "description": m["help"], **data})
    return {
        "resourceMetrics": [
            {
                "resource": {
                    "attributes": [
                        {"key": "service.name", "value": {"stringValue": "acp-tpu"}}
                    ]
                },
                "scopeMetrics": [
                    {"scope": {"name": "acp-tpu"}, "metrics": metrics}
                ],
            }
        ]
    }


class MetricsExporter:
    """Periodic OTLP-JSON push of the registry. start() is a no-op without
    an endpoint, mirroring the tracer's silent fallback."""

    def __init__(
        self,
        registry: Registry = REGISTRY,
        endpoint: Optional[str] = None,
        interval: float = 30.0,
    ):
        if endpoint is None:
            endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT", "")
        self.registry = registry
        self.endpoint = endpoint.rstrip("/")
        self.interval = interval
        self._start_nanos = int(time.time() * _NANOS)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if not self.endpoint or self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="otlp-metrics", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def export_once(self) -> bool:
        """One push; returns success. Used by the loop and by tests."""
        now = int(time.time() * _NANOS)
        doc = _to_otlp(self.registry.snapshot(), self._start_nanos, now)
        req = urllib.request.Request(
            f"{self.endpoint}/v1/metrics",
            data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return 200 <= resp.status < 300
        except Exception as e:  # a failed push is dropped
            log.debug("OTLP metrics export failed: %s", e)
            return False

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.export_once()
