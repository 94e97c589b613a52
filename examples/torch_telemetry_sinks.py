"""Scenario: wiring observability into the community service, on the
PyTorch port.

An operator wants to know, per request, where time went (queue vs
engine vs host), whether a dispatch key was seen before (the port's
``compile`` span: a key's first dispatch is a miss), and which
tenants are being served or rejected — and wants those numbers in their
own monitoring stack, not just a report dict.  This walks the telemetry
layer end to end:

1. the built-in sinks: ``telemetry_enabled=True`` attaches the
   in-memory aggregation sink (streaming histograms, bounded memory),
   ``telemetry_jsonl=...`` logs every event as a JSON line, and
   ``exporter_port=0`` serves Prometheus text on an ephemeral
   ``/metrics`` port;
2. per-request traces: every ``DetectionFuture`` carries the full span
   lifecycle (``submit ... compile(hit|miss) ... resolve``);
3. **custom sinks**: subclass ``MetricSink`` and override any subset of
   the hooks — here, a latency-threshold alerter and a tiny per-tenant
   tally.  A raising sink is isolated and recorded; it never breaks the
   serving path;
4. scraping: fetch the live exporter over HTTP and parse it with the
   bundled parser (what the CI smoke does mid-replay).

The service and its graphs live on ``--device`` (default ``cuda``).

  PYTHONPATH=src python examples/torch_telemetry_sinks.py [--device cpu]
"""
import argparse
import collections
import json
import os
import tempfile
import urllib.request

import numpy as np

from repro_torch.core import DetectOptions, LouvainConfig
from repro_torch.graph import sbm_graph
from repro_torch.service import CommunityService, ServiceConfig
from repro_torch.telemetry import MetricSink, metric_names, parse_prometheus


def ego(seed, device, n=36):
    return sbm_graph(n_nodes=n, n_blocks=3, p_in=0.4, p_out=0.04,
                     seed=seed, device=device)[0]


# ---------------------------------------------------------------------------
# custom sinks: override any subset of the MetricSink hooks
# ---------------------------------------------------------------------------

class SlowRequestAlerter(MetricSink):
    """Flag any phase span slower than a threshold — the shape of a
    pager/alerting bridge (swap ``print`` for your alert client)."""

    def __init__(self, threshold_s=0.25):
        self.threshold_s = threshold_s
        self.alerts = []

    def on_span(self, span):
        if span.duration_s >= self.threshold_s:
            self.alerts.append(span)
            print(f"  [alert] {span.trace_id}: {span.name} took "
                  f"{span.duration_s * 1e3:.0f} ms "
                  f"(labels={span.labels or {}})")


class TenantTally(MetricSink):
    """Count served requests per tenant — the shape of a StatsD/OTLP
    bridge (forward instead of accumulating)."""

    def __init__(self):
        self.served = collections.Counter()

    def on_counter(self, name, value, labels=None):
        if name == "requests_served":
            self.served[(labels or {}).get("tenant", "?")] += int(value)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args(argv).device
    jsonl = tempfile.NamedTemporaryFile(
        mode="w", suffix=".jsonl", delete=False)
    cfg = ServiceConfig(
        detect=DetectOptions(louvain=LouvainConfig()),
        batch_size=4, max_delay_s=0.01,
        telemetry_enabled=True,          # in-memory sink (the default)
        telemetry_jsonl=jsonl.name,      # + JSONL event log
        exporter_port=0,                 # + /metrics on an ephemeral port
    )
    svc = CommunityService(config=cfg, device=dev)

    # -- 3. register custom sinks on the same hub -------------------------
    alerter = svc.telemetry.register(SlowRequestAlerter(threshold_s=0.25))
    tally = svc.telemetry.register(TenantTally())

    # -- 1. serve some traffic -------------------------------------------
    print("== serving ==")
    futs = [svc.detect(f"g{i}", ego(i, dev),
                       tenant=("feed" if i % 2 else "ads"))
            for i in range(6)]
    svc.drain()
    # a warm update rides the delta-screening path (no recompute)
    entry = svc.result("g0")
    rng = np.random.default_rng(0)
    n = int(entry.graph.n_nodes)
    u, v = rng.integers(0, n, 3), rng.integers(0, n, 3)
    keep = u != v
    svc.submit_update("g0", (u[keep], v[keep],
                             np.ones(int(keep.sum()), np.float32)))

    # -- 2. per-request traces -------------------------------------------
    print("\n== the first request's trace ==")
    tr = futs[0].trace
    for s in tr.spans:
        print(f"  {s.name:<16} {s.duration_s * 1e3:8.3f} ms  "
              f"{s.labels or ''}")
    (compile_span,) = tr.find("compile")
    print("first dispatch of its key: "
          f"{'no' if compile_span.labels['hit'] == 'true' else 'yes'}")

    # -- aggregated view: phase breakdown + report ------------------------
    sink = svc.frontend.mem_sink
    bd = sink.phase_breakdown()
    print("\n== where the time went ==")
    print("  " + "  ".join(f"{k}: {v * 100:.1f}%"
                           for k, v in sorted(bd.items())))
    rep = svc.metrics.report()
    print(f"report (strict-JSON safe): p50 {rep['p50_ms']:.1f} ms, "
          f"{rep['n_detect']} detects, {rep['n_update']} updates")
    json.dumps(rep, allow_nan=False)     # null, never NaN

    # -- custom sink results ---------------------------------------------
    print(f"\ntally: {dict(tally.served)}")
    print(f"alerter fired {len(alerter.alerts)} time(s) "
          f"(the first batch usually trips it)")

    # -- 4. scrape the live exporter -------------------------------------
    url = svc.frontend.exporter.url
    body = urllib.request.urlopen(url, timeout=10).read().decode()
    parsed = parse_prometheus(body)
    print(f"\n== scraped {url} ==")
    print(f"  {len(parsed)} samples across "
          f"{len(metric_names(parsed))} families, e.g.:")
    for (name, labels), val in sorted(parsed.items()):
        if name == "repro_requests_served_total":
            print(f"  {name}{dict(labels)} = {val:g}")

    svc.close()                          # stops exporter, flushes JSONL
    with open(jsonl.name) as f:
        n_lines = sum(1 for _ in f)
    print(f"\nJSONL log: {n_lines} events in {jsonl.name}")
    os.unlink(jsonl.name)


if __name__ == "__main__":
    main()
