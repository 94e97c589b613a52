"""Pluggable metric sinks and the telemetry hub.

Callback-style observability: the service emits counters, gauges,
histogram observations, and completed request spans into a
:class:`Telemetry` hub, and any number of registered :class:`MetricSink`
subclasses receive them (``on_counter`` / ``on_gauge`` /
``on_histogram`` / ``on_span``).  Built-ins:

* :class:`InMemorySink` — thread-safe aggregation (counters sum, gauges
  keep last, observations stream into
  :class:`repro_torch.telemetry.histogram.StreamingHistogram`); backs the
  Prometheus exporter and the replay harness's phase breakdown.
* :class:`JsonlSink` — one JSON line per event, for offline analysis.

Write a custom sink by subclassing :class:`MetricSink` and overriding
any subset of the hooks (see ``examples/telemetry_sinks.py``).  Sink
errors are isolated: a raising sink never breaks the serving path (the
first error per sink is recorded on ``hub.sink_errors``, bounded at
``Telemetry.max_sink_errors`` with a drop counter).

The hub is cheap when nothing listens: every emit method early-outs on
an empty sink tuple, so a telemetry-disabled service pays one attribute
load + truth test per event.
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import Dict, Optional, TextIO, Tuple

from repro_torch.telemetry.histogram import StreamingHistogram
from repro_torch.telemetry.spans import RequestTrace, Span

# labels are flattened to a hashable, order-independent key
LabelKey = Tuple[Tuple[str, str], ...]


def label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricSink:
    """Base class: override any subset of the event hooks."""

    def on_counter(self, name: str, value: float,
                   labels: Optional[Dict[str, str]] = None):
        pass

    def on_gauge(self, name: str, value: float,
                 labels: Optional[Dict[str, str]] = None):
        pass

    def on_histogram(self, name: str, value: float,
                     labels: Optional[Dict[str, str]] = None):
        pass

    def on_span(self, span: Span):
        pass

    def close(self):
        pass


class Telemetry:
    """The hub: emit-side API for the service, registry for sinks.

    Sink exceptions never break serving: ``_guard`` records the first
    error per sink in ``sink_errors``, bounded at ``max_sink_errors``
    entries (oldest dropped, counted in ``n_sink_errors_dropped``) so a
    long-lived service churning through failing sinks cannot grow the
    record without bound; ``n_sink_errors`` counts every guarded raise.
    """

    max_sink_errors = 16

    def __init__(self):
        self._sinks: Tuple[MetricSink, ...] = ()
        self._lock = threading.Lock()
        self.sink_errors: "OrderedDict[int, BaseException]" = OrderedDict()
        self.n_sink_errors = 0
        self.n_sink_errors_dropped = 0

    # -- registry ---------------------------------------------------------
    def register(self, sink: MetricSink) -> MetricSink:
        with self._lock:
            self._sinks = self._sinks + (sink,)
        return sink

    def unregister(self, sink: MetricSink):
        with self._lock:
            self._sinks = tuple(s for s in self._sinks if s is not sink)

    @property
    def sinks(self) -> Tuple[MetricSink, ...]:
        return self._sinks

    @property
    def enabled(self) -> bool:
        return bool(self._sinks)

    def close(self):
        sinks, self._sinks = self._sinks, ()
        for s in sinks:
            self._guard(s, s.close)

    # -- emit -------------------------------------------------------------
    def counter(self, name: str, value: float = 1.0,
                labels: Optional[Dict[str, str]] = None):
        for s in self._sinks:
            self._guard(s, s.on_counter, name, value, labels)

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, str]] = None):
        for s in self._sinks:
            self._guard(s, s.on_gauge, name, value, labels)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None):
        for s in self._sinks:
            self._guard(s, s.on_histogram, name, value, labels)

    def span(self, span: Span):
        for s in self._sinks:
            self._guard(s, s.on_span, span)

    def trace(self, trace: RequestTrace):
        """Broadcast every span of a completed request trace."""
        if not self._sinks:
            return
        for sp in trace.spans:
            self.span(sp)

    def _guard(self, sink: MetricSink, fn, *args):
        try:
            fn(*args)
        except Exception as e:          # sink bugs never break serving
            with self._lock:
                self.n_sink_errors += 1
                if id(sink) not in self.sink_errors:
                    self.sink_errors[id(sink)] = e
                    while len(self.sink_errors) > self.max_sink_errors:
                        self.sink_errors.popitem(last=False)
                        self.n_sink_errors_dropped += 1


class InMemorySink(MetricSink):
    """Thread-safe aggregation: the default sink behind ``/metrics``.

    ``counters[(name, labels)] -> float`` (summed),
    ``gauges[(name, labels)] -> float`` (last write wins),
    ``histograms[(name, labels)] -> StreamingHistogram``.
    Spans aggregate into ``histograms[("span_duration_seconds",
    (("phase", name),))]`` so per-phase latency distributions fall out
    without custom plumbing.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[Tuple[str, LabelKey], float] = {}
        self.gauges: Dict[Tuple[str, LabelKey], float] = {}
        self.histograms: Dict[Tuple[str, LabelKey], StreamingHistogram] = {}
        self.n_spans = 0

    def on_counter(self, name, value, labels=None):
        k = (name, label_key(labels))
        with self._lock:
            self.counters[k] = self.counters.get(k, 0.0) + float(value)

    def on_gauge(self, name, value, labels=None):
        with self._lock:
            self.gauges[(name, label_key(labels))] = float(value)

    def on_histogram(self, name, value, labels=None):
        k = (name, label_key(labels))
        with self._lock:
            h = self.histograms.get(k)
            if h is None:
                h = self.histograms[k] = StreamingHistogram()
        h.add(value)

    def on_span(self, span: Span):
        self.n_spans += 1
        self.on_histogram("span_duration_seconds", span.duration_s,
                          {"phase": span.name})

    # -- queries ----------------------------------------------------------
    def counter_value(self, name: str, labels=None) -> float:
        return self.counters.get((name, label_key(labels)), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum of a counter across all label sets."""
        return sum(v for (n, _), v in self.counters.items() if n == name)

    def histogram(self, name: str, labels=None) -> Optional[StreamingHistogram]:
        return self.histograms.get((name, label_key(labels)))

    def phase_durations(self) -> Dict[str, StreamingHistogram]:
        """phase name -> latency histogram, from aggregated spans."""
        out = {}
        for (name, lk), h in self.histograms.items():
            if name == "span_duration_seconds":
                labels = dict(lk)
                out[labels.get("phase", "?")] = h
        return out

    def phase_breakdown(self) -> Dict[str, float]:
        """queue / engine / host share of total per-request span time
        (fractions summing to 1.0 when any spans were recorded)."""
        from repro_torch.telemetry.spans import phase_group
        totals = {"queue": 0.0, "engine": 0.0, "host": 0.0}
        for phase, h in self.phase_durations().items():
            totals[phase_group(phase)] += h.sum
        grand = sum(totals.values())
        if grand <= 0.0:
            return {k: 0.0 for k in totals}
        return {k: v / grand for k, v in totals.items()}

    def reset(self):
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.histograms.clear()
            self.n_spans = 0


class JsonlSink(MetricSink):
    """One JSON line per event, to a path or an open text stream."""

    def __init__(self, path_or_stream):
        if hasattr(path_or_stream, "write"):
            self._f: TextIO = path_or_stream
            self._owned = False
        else:
            self._f = open(path_or_stream, "a")
            self._owned = True
        self._lock = threading.Lock()

    def _emit(self, obj: dict):
        line = json.dumps(obj, separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")

    def on_counter(self, name, value, labels=None):
        self._emit(dict(ev="counter", name=name, value=value,
                        labels=labels or {}))

    def on_gauge(self, name, value, labels=None):
        self._emit(dict(ev="gauge", name=name, value=value,
                        labels=labels or {}))

    def on_histogram(self, name, value, labels=None):
        self._emit(dict(ev="histogram", name=name, value=value,
                        labels=labels or {}))

    def on_span(self, span: Span):
        self._emit(dict(ev="span", **span.as_dict()))

    def close(self):
        with self._lock:
            self._f.flush()
            if self._owned:
                self._f.close()
