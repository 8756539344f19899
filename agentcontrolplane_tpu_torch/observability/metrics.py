"""Metrics registry: Prometheus-text-format counters, gauges and
histograms (the port's copy of the reference's ``observability/metrics.py``).

The Task controller counts its early-dispatched and orphaned ToolCalls
into ``REGISTRY``; the operator's REST server serves it at ``/metrics``
with the object and engine gauges it sets at scrape time. The OTLP
metrics push comes with the rest of the observability layer (ROADMAP
A.11).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field


@dataclass
class _Metric:
    name: str
    help: str
    type: str
    values: dict[tuple[tuple[str, str], ...], float] = field(default_factory=dict)


HIST_WINDOW = 4096  # bounded reservoir per series (quantiles over a window)


class Registry:
    def __init__(self, hist_window: int = HIST_WINDOW):
        self._metrics: dict[str, _Metric] = {}
        self._hist_window = hist_window
        self._hist_data: dict[str, dict[tuple, "deque[float]"]] = {}
        self._hist_count: dict[str, dict[tuple, int]] = {}
        self._hist_sum: dict[str, dict[tuple, float]] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, help: str, type_: str) -> _Metric:
        m = self._metrics.get(name)
        if m is None:
            m = _Metric(name=name, help=help, type=type_)
            self._metrics[name] = m
        return m

    @staticmethod
    def _key(labels: dict[str, str] | None) -> tuple[tuple[str, str], ...]:
        return tuple(sorted((labels or {}).items()))

    def counter_add(self, name: str, value: float = 1.0, labels: dict[str, str] | None = None, help: str = "") -> None:
        with self._lock:
            m = self._get(name, help, "counter")
            k = self._key(labels)
            m.values[k] = m.values.get(k, 0.0) + value

    def gauge_set(self, name: str, value: float, labels: dict[str, str] | None = None, help: str = "") -> None:
        with self._lock:
            m = self._get(name, help, "gauge")
            m.values[self._key(labels)] = value

    def gauge_remove(self, name: str, labels: dict[str, str] | None = None) -> None:
        """Drop one gauge series (cardinality hygiene: a drained kind/phase
        series is zeroed for one scrape, then removed)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                m.values.pop(self._key(labels), None)

    def observe(self, name: str, value: float, labels: dict[str, str] | None = None, help: str = "") -> None:
        with self._lock:
            self._get(name, help, "histogram")
            k = self._key(labels)
            series = self._hist_data.setdefault(name, {})
            if k not in series:
                series[k] = deque(maxlen=self._hist_window)
            series[k].append(value)
            counts = self._hist_count.setdefault(name, {})
            counts[k] = counts.get(k, 0) + 1
            sums = self._hist_sum.setdefault(name, {})
            sums[k] = sums.get(k, 0.0) + value

    def series_window(
        self, name: str, labels: dict[str, str] | None = None
    ) -> tuple[int, list[float]]:
        """(total observation count, windowed values) for one histogram
        series, read under the lock. The count is monotonic (unbounded)
        while the window is the bounded reservoir — callers measuring a
        phase snapshot the count before and slice
        ``window[-min(new, len(window)):]`` after."""
        with self._lock:
            k = self._key(labels)
            count = self._hist_count.get(name, {}).get(k, 0)
            window = list(self._hist_data.get(name, {}).get(k, ()))
        return count, window

    def quantile(self, name: str, q: float, labels: dict[str, str] | None = None) -> float:
        with self._lock:
            data = sorted(self._hist_data.get(name, {}).get(self._key(labels), []))
        if not data:
            return 0.0
        idx = min(int(q * len(data)), len(data) - 1)
        return data[idx]

    def render(self) -> str:
        """Prometheus text exposition format."""
        out: list[str] = []
        with self._lock:
            for m in self._metrics.values():
                if m.help:
                    out.append(f"# HELP {m.name} {self._escape_help(m.help)}")
                out.append(f"# TYPE {m.name} {m.type if m.type != 'histogram' else 'summary'}")
                if m.type == "histogram":
                    for k, vals in self._hist_data.get(m.name, {}).items():
                        lbl = self._render_labels(k)
                        svals = sorted(vals)  # windowed quantiles
                        for q in (0.5, 0.9, 0.99):
                            qk = self._render_labels(k + (("quantile", str(q)),))
                            idx = min(int(q * len(svals)), len(svals) - 1)
                            out.append(f"{m.name}{qk} {svals[idx]}")
                        out.append(f"{m.name}_count{lbl} {self._hist_count[m.name][k]}")
                        out.append(f"{m.name}_sum{lbl} {self._hist_sum[m.name][k]}")
                else:
                    for k, v in m.values.items():
                        out.append(f"{m.name}{self._render_labels(k)} {v}")
        return "\n".join(out) + "\n"

    @staticmethod
    def _escape_label_value(value: str) -> str:
        """Prometheus text-format label-value escaping: backslash, double
        quote, and line feed must be escaped or a value like a model name
        containing ``"`` (or a fault label carrying a newline) corrupts the
        whole scrape — every series after it fails to parse."""
        return (
            str(value)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )

    @staticmethod
    def _escape_help(text: str) -> str:
        """HELP-line escaping per the text format: backslash and line feed
        (a raw newline would split the HELP text into a garbage line)."""
        return str(text).replace("\\", "\\\\").replace("\n", "\\n")

    @classmethod
    def _render_labels(cls, k: tuple[tuple[str, str], ...]) -> str:
        if not k:
            return ""
        inner = ",".join(
            f'{name}="{cls._escape_label_value(value)}"' for name, value in k
        )
        return "{" + inner + "}"

    def snapshot(self) -> list[dict]:
        """Structured dump for programmatic exporters (OTLP metrics)."""
        out: list[dict] = []
        with self._lock:
            for m in self._metrics.values():
                entry: dict = {"name": m.name, "type": m.type, "help": m.help}
                if m.type == "histogram":
                    series = []
                    for k, vals in self._hist_data.get(m.name, {}).items():
                        svals = sorted(vals)
                        series.append(
                            {
                                "labels": dict(k),
                                "count": self._hist_count[m.name][k],
                                "sum": self._hist_sum[m.name][k],
                                "quantiles": {
                                    q: svals[min(int(q * len(svals)), len(svals) - 1)]
                                    for q in (0.5, 0.9, 0.99)
                                }
                                if svals
                                else {},
                            }
                        )
                    entry["series"] = series
                else:
                    entry["series"] = [
                        {"labels": dict(k), "value": v} for k, v in m.values.items()
                    ]
                out.append(entry)
        return out


REGISTRY = Registry()
