"""Service metrics (port of ``repro/service/metrics.py``, the same code over
the port's copy of the telemetry package): aggregate latency/throughput
plus per-tenant served/rejected breakdowns (the numbers admission fairness
is judged by).

Latencies stream into fixed-size log-bucketed histograms
(:class:`repro_torch.telemetry.histogram.StreamingHistogram`) instead of
append-only lists, so memory stays bounded under sustained traffic while
p50/p99 stay within ~1% of the exact percentiles.  ``report()`` keeps its
public shape, with one deliberate change: percentile/rate fields that
have no data are ``None`` (JSON ``null``) rather than ``nan`` — ``nan``
breaks ``json.dumps(..., allow_nan=False)`` consumers.

When a :class:`repro_torch.telemetry.sinks.Telemetry` hub is attached, every
observation is mirrored to the registered sinks as labeled counters
(``requests_served{tenant,kind}``, ``requests_rejected{tenant}``,
``requests_failed{tenant}``) and histograms
(``request_latency_seconds{kind}`` — no tenant label, bounding exporter
cardinality to the kind axis).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.telemetry.histogram import StreamingHistogram
from repro_torch.telemetry.sinks import Telemetry


def percentile(xs, p: float) -> float:
    """Exact percentile of a sequence (kept for callers/benchmarks that
    hold their own samples); :class:`StreamingHistogram` handles the
    service's own aggregation."""
    if isinstance(xs, StreamingHistogram):
        return xs.percentile(p)
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs), p))


def _ms(hist: StreamingHistogram, p: float) -> Optional[float]:
    """Percentile in milliseconds, None (JSON null) when empty."""
    if not len(hist):
        return None
    return hist.percentile(p) * 1e3


class TenantMetrics:
    """Per-tenant served/rejected counts + latency histogram."""

    __slots__ = ("n_detect", "n_update", "n_rejected", "n_failed",
                 "latency")

    def __init__(self):
        self.n_detect = 0
        self.n_update = 0
        self.n_rejected = 0
        self.n_failed = 0
        self.latency = StreamingHistogram()

    @property
    def served(self) -> int:
        return self.n_detect + self.n_update

    def report(self) -> dict:
        return dict(
            served=self.served,
            n_detect=self.n_detect,
            n_update=self.n_update,
            n_rejected=self.n_rejected,
            n_failed=self.n_failed,
            p50_ms=_ms(self.latency, 50),
            p99_ms=_ms(self.latency, 99),
        )


class ServiceMetrics:
    """Aggregate service counters; attribute-incremented by the front
    end (``metrics.n_rebucketed += 1`` etc.), histogram-backed for
    latencies, optionally mirrored to a telemetry hub."""

    def __init__(self, telemetry: Optional[Telemetry] = None):
        self.telemetry = telemetry or Telemetry()
        self.detect_latency = StreamingHistogram()
        self.update_latency = StreamingHistogram()
        self.n_detect = 0
        self.n_update = 0
        self.n_rebucketed = 0
        self.n_rejected = 0
        self.n_failed = 0
        self.n_update_batches = 0        # batched warm-path dispatches
        self.n_updates_batched = 0       # graphs served via update batches
        self.n_deletions = 0             # directed edges removed by updates
        self.n_vertex_added = 0          # vertices claimed by updates
        self.n_vertex_removed = 0        # vertices tombstoned by updates
        self.edges_processed = 0.0       # directed edges through the engine
        self.n_deadline_rejects = 0      # futures failed DeadlineExceeded
        self.n_retries = 0               # dispatch/commit attempts retried
        self.n_batch_splits = 0          # failed batches split-in-half
        self.n_degraded = 0              # requests served by degraded tier
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.tenants: Dict[str, TenantMetrics] = {}

    def reset(self):
        # the hub (and its registered sinks) survives a reset: counters
        # zero, sinks keep their monotonic totals (Prometheus semantics)
        self.__init__(telemetry=self.telemetry)

    def tenant(self, name: str) -> TenantMetrics:
        tm = self.tenants.get(name)
        if tm is None:
            tm = self.tenants[name] = TenantMetrics()
        return tm

    def observe(self, kind: str, latency_s: float, now: float,
                tenant: str = "default"):
        (self.detect_latency if kind == "detect"
         else self.update_latency).add(latency_s)
        tm = self.tenant(tenant)
        if kind == "detect":
            self.n_detect += 1
            tm.n_detect += 1
        else:
            self.n_update += 1
            tm.n_update += 1
        tm.latency.add(latency_s)
        self.t_first = now if self.t_first is None else self.t_first
        self.t_last = now
        tel = self.telemetry
        if tel.enabled:
            tel.counter("requests_served", 1,
                        {"tenant": tenant, "kind": kind})
            tel.observe("request_latency_seconds", latency_s,
                        {"kind": kind})

    def reject(self, tenant: str = "default"):
        self.n_rejected += 1
        self.tenant(tenant).n_rejected += 1
        if self.telemetry.enabled:
            self.telemetry.counter("requests_rejected", 1,
                                   {"tenant": tenant})

    def deadline_reject(self, tenant: str = "default"):
        """An already-expired-deadline request failed fast (distinct from
        queue rejections: the work was never dispatched)."""
        self.n_deadline_rejects += 1
        if self.telemetry.enabled:
            self.telemetry.counter("deadline_rejects", 1,
                                   {"tenant": tenant})

    def fail(self, tenant: str = "default"):
        self.n_failed += 1
        self.tenant(tenant).n_failed += 1
        if self.telemetry.enabled:
            self.telemetry.counter("requests_failed", 1, {"tenant": tenant})

    def report(self) -> dict:
        lat = StreamingHistogram()
        lat.merge(self.detect_latency)
        lat.merge(self.update_latency)
        span = ((self.t_last - self.t_first)
                if (self.t_first is not None and self.t_last > self.t_first)
                else None)
        served = self.n_detect + self.n_update
        return dict(
            n_detect=self.n_detect,
            n_update=self.n_update,
            n_rebucketed=self.n_rebucketed,
            n_rejected=self.n_rejected,
            n_failed=self.n_failed,
            n_update_batches=self.n_update_batches,
            n_deadline_rejects=self.n_deadline_rejects,
            n_retries=self.n_retries,
            n_batch_splits=self.n_batch_splits,
            n_degraded=self.n_degraded,
            n_deletions=self.n_deletions,
            n_vertex_added=self.n_vertex_added,
            n_vertex_removed=self.n_vertex_removed,
            update_batch_mean=(self.n_updates_batched / self.n_update_batches
                               if self.n_update_batches else None),
            p50_ms=_ms(lat, 50),
            p99_ms=_ms(lat, 99),
            p50_detect_ms=_ms(self.detect_latency, 50),
            p50_update_ms=_ms(self.update_latency, 50),
            graphs_per_s=served / span if span else None,
            edges_per_s=(self.edges_processed / span if span else None),
            tenants={name: tm.report()
                     for name, tm in sorted(self.tenants.items())},
        )
