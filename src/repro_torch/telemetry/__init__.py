"""Structured telemetry for the community-detection service (the port's own
copy of ``repro/telemetry/``: only the module paths differ).

Four layers (see README "Observability"):

* :mod:`repro_torch.telemetry.spans` — per-request lifecycle traces
  (``submit -> ... -> resolve``) with monotonic-clock spans.
* :mod:`repro_torch.telemetry.sinks` — the :class:`Telemetry` hub plus
  pluggable :class:`MetricSink` callbacks (in-memory aggregation, JSONL
  event log, custom).
* :mod:`repro_torch.telemetry.histogram` — fixed-size streaming latency
  histograms (replaces the unbounded lists ``service/metrics.py`` used).
* :mod:`repro_torch.telemetry.prometheus` — text-format exporter over stdlib
  ``http.server`` plus a parser for scrape assertions.
"""
from repro_torch.telemetry.histogram import StreamingHistogram
from repro_torch.telemetry.prometheus import (
    MetricsExporter, metric_names, parse_prometheus, render_prometheus,
)
from repro_torch.telemetry.sinks import (
    InMemorySink, JsonlSink, MetricSink, Telemetry,
)
from repro_torch.telemetry.spans import (
    PHASES, RequestTrace, Span, phase_group,
)

__all__ = [
    "StreamingHistogram",
    "MetricsExporter", "metric_names", "parse_prometheus",
    "render_prometheus",
    "InMemorySink", "JsonlSink", "MetricSink", "Telemetry",
    "PHASES", "RequestTrace", "Span", "phase_group",
]
