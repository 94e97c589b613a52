"""The port's copy of the telemetry package (``repro_torch.telemetry``) and
its service metrics (``repro_torch.service.metrics``), on the CPU.

The histogram, sink-registry, JSONL and Prometheus cases of
tests/test_telemetry.py run against the port's copy; then one seeded
observation stream goes through both packages, which must report equal
percentiles, equal ``ServiceMetrics.report()`` dicts and the same
Prometheus text.  The exporter is scraped over ``127.0.0.1``.
"""
import io
import json
import urllib.request

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

import repro.service.metrics as j_metrics
import repro.telemetry as jtel
import repro_torch.service.metrics as t_metrics
import repro_torch.telemetry as ttel
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.telemetry import (
    PHASES, InMemorySink, JsonlSink, MetricsExporter, RequestTrace,
    StreamingHistogram, Telemetry, metric_names, parse_prometheus,
    render_prometheus,
)


# ---------------------------------------------------------------------------
# streaming histogram
# ---------------------------------------------------------------------------

def test_histogram_percentiles_within_1pct():
    rng = np.random.default_rng(7)
    xs = rng.lognormal(mean=-4.0, sigma=1.5, size=20_000)
    h = StreamingHistogram()
    for x in xs:
        h.add(float(x))
    for p in (50, 90, 99, 99.9):
        exact = float(np.percentile(xs, p))
        approx = h.percentile(p)
        assert abs(approx - exact) / exact <= 0.01, (p, approx, exact)
    assert h.n == len(xs)
    assert abs(h.sum - xs.sum()) / xs.sum() < 1e-9
    assert h.percentile(0) == pytest.approx(xs.min(), rel=0.01)
    assert h.percentile(100) == pytest.approx(xs.max(), rel=0.01)
    assert xs.min() <= h.percentile(0) <= h.percentile(100) <= xs.max()


def test_histogram_memory_is_bounded_and_merge_works():
    h1, h2 = StreamingHistogram(), StreamingHistogram()
    for i in range(10_000):
        h1.add(1e-3 * (1 + i % 7))
        h2.add(1e-2 * (1 + i % 5))
    assert len(h1.counts) == len(h2.counts)
    n1 = h1.n
    h1.merge(h2)
    assert h1.n == n1 + h2.n
    assert h1.cumulative_le(1e2) == h1.n


def test_histogram_ignores_nan_and_handles_empty():
    h = StreamingHistogram()
    assert h.percentile(99) != h.percentile(99)  # NaN on empty
    h.add(float("nan"))
    assert h.n == 0
    h.add(0.0)                                   # underflow bucket
    h.add(1e9)                                   # overflow bucket
    assert h.n == 2
    assert h.cumulative_le(1e-7) == 1


# ---------------------------------------------------------------------------
# metrics report: JSON-safe nulls
# ---------------------------------------------------------------------------

def test_empty_report_serializes_without_nan():
    rep = ServiceMetrics().report()
    json.dumps(rep, allow_nan=False)
    for key in ("p50_ms", "p99_ms", "p50_detect_ms", "p50_update_ms",
                "graphs_per_s", "edges_per_s", "update_batch_mean"):
        assert rep[key] is None, (key, rep[key])


def test_populated_report_stays_json_safe():
    m = ServiceMetrics()
    m.observe("detect", 0.010, 1.0, tenant="a")
    m.observe("update", 0.002, 1.5, tenant="b")
    m.reject("b")
    rep = m.report()
    json.dumps(rep, allow_nan=False)
    assert rep["p50_ms"] is not None and rep["p50_ms"] > 0
    assert rep["tenants"]["b"]["n_rejected"] == 1
    assert rep["tenants"]["b"]["p50_ms"] == pytest.approx(2.0, rel=0.02)
    m.reset()
    json.dumps(m.report(), allow_nan=False)


# ---------------------------------------------------------------------------
# sink registry, JSONL
# ---------------------------------------------------------------------------

def test_sink_registry_fanout_and_unregister():
    hub = Telemetry()
    assert not hub.enabled
    a, b = InMemorySink(), InMemorySink()
    hub.register(a)
    hub.register(b)
    assert hub.enabled
    hub.counter("x", 2, {"t": "u"})
    hub.gauge("g", 0.5)
    hub.observe("h", 0.01)
    assert a.counter_value("x", {"t": "u"}) == 2
    assert b.counter_value("x", {"t": "u"}) == 2
    hub.unregister(b)
    hub.counter("x", 1, {"t": "u"})
    assert a.counter_value("x", {"t": "u"}) == 3
    assert b.counter_value("x", {"t": "u"}) == 2


def test_broken_sink_is_isolated_and_recorded():
    class Broken(InMemorySink):
        def on_counter(self, *a, **kw):
            raise RuntimeError("sink exploded")

    hub = Telemetry()
    broken = hub.register(Broken())
    good = hub.register(InMemorySink())
    hub.counter("x", 1)
    hub.counter("x", 1)
    assert good.counter_value("x") == 2
    assert id(broken) in hub.sink_errors


def test_jsonl_sink_emits_parseable_lines():
    buf = io.StringIO()
    hub = Telemetry()
    hub.register(JsonlSink(buf))
    hub.counter("served", 1, {"tenant": "a"})
    tr = RequestTrace("r1", tenant="a", kind="detect")
    tr.mark("submit", 0.0, 0.5)
    hub.trace(tr)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines()]
    assert any(o.get("name") == "served" for o in lines)
    spans = [o for o in lines if o.get("ev") == "span"]
    assert spans and spans[0]["trace_id"] == "r1"
    assert spans[0]["duration_s"] == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# prometheus
# ---------------------------------------------------------------------------

def test_prometheus_round_trip():
    sink = InMemorySink()
    sink.on_counter("requests_served", 3, {"tenant": "a", "kind": "detect"})
    sink.on_gauge("queue_depth", 2, {"tenant": "a"})
    for v in (0.001, 0.002, 0.04):
        sink.on_histogram("request_latency_seconds", v, {"kind": "detect"})
    parsed = parse_prometheus(render_prometheus(sink))
    names = metric_names(parsed)
    assert {"repro_requests_served_total", "repro_queue_depth",
            "repro_request_latency_seconds_bucket",
            "repro_request_latency_seconds_sum",
            "repro_request_latency_seconds_count"} <= names
    key = ("repro_requests_served_total",
           (("kind", "detect"), ("tenant", "a")))
    assert parsed[key] == 3
    cnt = ("repro_request_latency_seconds_count", (("kind", "detect"),))
    assert parsed[cnt] == 3
    ladder = sorted(
        (dict(lk)["le"], v) for (n, lk), v in parsed.items()
        if n == "repro_request_latency_seconds_bucket")
    vals = [v for _, v in ladder]
    assert vals[-1] == 3 and all(a <= 3 for a in vals)


def test_parse_rejects_garbage():
    with pytest.raises(ValueError):
        parse_prometheus("this is { not prometheus\n")


def test_exporter_live_http_scrape():
    sink = InMemorySink()
    sink.on_counter("requests_served", 5, {"tenant": "t0"})
    exp = MetricsExporter(sink, port=0)
    # the scrape stays on the loopback: no proxy from the environment
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    assert exp.url.startswith("http://127.0.0.1:")
    try:
        body = opener.open(exp.url, timeout=10).read().decode()
        parsed = parse_prometheus(body)
        assert parsed[("repro_requests_served_total",
                       (("tenant", "t0"),))] == 5
        sink.on_counter("requests_served", 1, {"tenant": "t0"})
        body = opener.open(exp.url, timeout=10).read().decode()
        assert parse_prometheus(body)[("repro_requests_served_total",
                                       (("tenant", "t0"),))] == 6
    finally:
        exp.close()


# ---------------------------------------------------------------------------
# the port's copy against the reference, on one observation stream
# ---------------------------------------------------------------------------

def _drive(metrics_mod, tel_mod, seed):
    """A seeded stream of observations through one package's
    ServiceMetrics with an in-memory sink attached."""
    hub = tel_mod.Telemetry()
    sink = hub.register(tel_mod.InMemorySink())
    m = metrics_mod.ServiceMetrics(telemetry=hub)
    rng = np.random.default_rng(seed)
    now = 0.0
    for _ in range(2_000):
        now += float(rng.exponential(0.003))
        tenant = f"t{int(rng.integers(0, 4))}"
        x = rng.random()
        if x < 0.8:
            m.observe("detect" if x < 0.6 else "update",
                      float(rng.lognormal(-5.0, 1.0)), now, tenant=tenant)
        elif x < 0.9:
            m.reject(tenant)
        elif x < 0.95:
            m.fail(tenant)
        else:
            m.deadline_reject(tenant)
    m.n_update_batches, m.n_updates_batched = 7, 23
    m.edges_processed = 12345.0
    tr = tel_mod.RequestTrace("r", tenant="t0", kind="detect")
    for i, ph in enumerate(tel_mod.PHASES):
        tr.mark(ph, 0.001 * i, 0.001 * i + 0.0005)
    hub.trace(tr)
    hist = m.detect_latency
    pct = [hist.percentile(p) for p in (0, 50, 90, 99, 99.9, 100)]
    return m.report(), pct, tel_mod.render_prometheus(sink)


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_and_exports_equal_the_reference(seed):
    got = _drive(t_metrics, ttel, seed)
    want = _drive(j_metrics, jtel, seed)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    json.dumps(got[0], allow_nan=False)
    assert tuple(PHASES) == tuple(jtel.PHASES)
