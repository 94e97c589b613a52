"""Request traces, the tenant mirror and the exporter through the PyTorch
port's front end, and its replay harness, on the CPU.

Mirrors the front-end half of tests/test_telemetry.py: every resolved
future carries a complete trace whose span names come in the reference's
order (sync adapter, ``ServiceFrontend`` and the async front end; the
immediate, batched and re-bucketed update paths), the tenant counters
mirrored into the in-memory sink, a service with telemetry off, the
exporter's config check, a live Prometheus scrape of a serving front end
(over 127.0.0.1) and a short open-loop replay.  Where the sync cases run
on a scripted clock, the span names, their order and the sink's counters
are compared with the reference's run of the same scenario.
"""
import asyncio
import json
import urllib.request

import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_service import (
    FakeClock, as_input, config, ego, edge_updates, frontend,
    overflow_updates, span_names, sync_service,
)

import repro_torch.service as tservice
from repro_torch.service import AsyncCommunityService
from repro_torch.service.replay import (
    ReplayConfig, build_graph_pool, find_knee, run_replay,
)
from repro_torch.telemetry import PHASES, metric_names, parse_prometheus

DETECT_PHASES = set(PHASES)
IMMEDIATE_UPDATE_PHASES = {"submit", "repad", "compile", "engine-dispatch",
                           "device-sync", "store-commit", "resolve"}
BATCHED_UPDATE_PHASES = DETECT_PHASES - {"admission"}


def _both(run):
    return run(True), run(False)


def test_sync_adapter_detect_trace_is_complete():
    def run(port):
        svc = sync_service(port, clock=FakeClock(), batch_size=2,
                           max_delay_s=0.01)
        fut = svc.detect("g0", as_input(port, ego(0)))
        svc.drain()
        return fut

    ft, fj = _both(run)
    assert ft.done()
    assert set(span_names(ft)) == DETECT_PHASES
    assert span_names(ft) == span_names(fj)
    assert ft.trace.trace_id == ft.req_id == fj.req_id
    assert all(v >= 0 for v in ft.trace.durations().values())
    order = span_names(ft)
    assert order.index("submit") < order.index("queue-wait") \
        < order.index("engine-dispatch") < order.index("resolve")


def test_frontend_and_async_traces_match_sync():
    fe = frontend(True, batch_size=2, max_delay_s=0.01)
    f1 = fe.submit_detect("g0", as_input(True, ego(0)))
    fe.drain()

    async def go():
        async with AsyncCommunityService(
                config(True, batch_size=2, max_delay_s=0.01),
                device="cpu") as svc:
            fut = await svc.submit_detect("g0", as_input(True, ego(0)))
            await fut
            return fut

    f2 = asyncio.run(go())
    assert set(span_names(f1)) == set(span_names(f2)) == DETECT_PHASES


def test_immediate_update_trace():
    def run(port):
        svc = sync_service(port, clock=FakeClock(), batch_size=2,
                           max_delay_s=0.01)
        svc.detect("g0", as_input(port, ego(0)))
        svc.drain()
        fut = svc.frontend.submit_update("g0",
                                         edge_updates(svc.result("g0"), 1))
        assert fut.kind == "update" and fut.done()
        return fut

    ft, fj = _both(run)
    assert set(span_names(ft)) == IMMEDIATE_UPDATE_PHASES
    assert span_names(ft) == span_names(fj)
    (compile_span,) = ft.trace.find("compile")
    assert compile_span.labels["hit"] in ("true", "false")


def test_batched_update_trace():
    def run(port):
        svc = sync_service(port, clock=FakeClock(), batch_size=2,
                           max_delay_s=0.01, update_batch_size=2)
        for i in range(2):
            svc.detect(f"g{i}", as_input(port, ego(i)))
        svc.drain()
        futs = [svc.frontend.submit_update(
            f"g{i}", edge_updates(svc.result(f"g{i}"), i))
            for i in range(2)]
        svc.drain()
        return futs

    ft, fj = _both(run)
    for a, b in zip(ft, fj):
        assert a.done()
        assert set(span_names(a)) == BATCHED_UPDATE_PHASES, span_names(a)
        assert span_names(a) == span_names(b)


def test_rebucket_path_trace_is_complete():
    def run(port):
        svc = sync_service(port, clock=FakeClock(), batch_size=2,
                           max_delay_s=0.01)
        svc.detect("g0", as_input(port, ego(0)))
        svc.drain()
        fut = svc.frontend.submit_update(
            "g0", overflow_updates(svc.result("g0").graph))
        assert fut.kind == "detect"
        svc.drain()
        assert fut.done()
        return fut

    ft, fj = _both(run)
    assert set(span_names(ft)) == DETECT_PHASES
    assert span_names(ft) == span_names(fj)


def test_resolved_future_always_has_closed_trace():
    async def go():
        async with AsyncCommunityService(
                config(True, batch_size=4, max_delay_s=0.005),
                device="cpu") as svc:
            futs = [await svc.submit_detect(f"g{i}", as_input(True, ego(i)))
                    for i in range(4)]
            done = []

            async def watch(f):
                await f
                done.append(set(span_names(f)))

            await asyncio.gather(*(watch(f) for f in futs))
            return done

    for names in asyncio.run(go()):
        assert "resolve" in names and names == DETECT_PHASES


def test_tenant_metrics_mirrored_to_sink():
    def run(port):
        svc = sync_service(port, clock=FakeClock(), batch_size=2,
                           max_delay_s=0.01)
        svc.detect("g0", as_input(port, ego(0)), tenant="alice")
        svc.detect("g1", as_input(port, ego(1)), tenant="bob")
        svc.drain()
        return svc.frontend.mem_sink

    st, sj = _both(run)
    assert st.counter_value("requests_served",
                            {"tenant": "alice", "kind": "detect"}) == 1
    assert st.counter_value("requests_served",
                            {"tenant": "bob", "kind": "detect"}) == 1
    h = st.histogram("request_latency_seconds", {"kind": "detect"})
    assert h is not None and h.n == 2
    # the front end's counters, as the reference's (its engine alone adds
    # a fill gauge, which the port's unpadded loop has no use for)
    keep = ("requests_served", "detect_served_tier", "louvain_passes",
            "local_move_sweeps", "split_moves")
    for name in keep:
        assert st.counter_total(name) == sj.counter_total(name), name


def test_telemetry_disabled_leaves_no_sink_and_still_serves():
    svc = sync_service(True, batch_size=2, max_delay_s=0.01,
                       telemetry_enabled=False)
    assert svc.frontend.mem_sink is None
    fut = svc.detect("g0", as_input(True, ego(0)))
    svc.drain()
    assert fut.done() and fut.result().n_disconnected == 0
    json.dumps(svc.metrics.report(), allow_nan=False)


def test_exporter_config_requires_telemetry():
    with pytest.raises(ValueError):
        config(True, telemetry_enabled=False, exporter_port=0)


def test_service_exporter_scrapes_during_traffic():
    svc = sync_service(True, batch_size=2, max_delay_s=0.01,
                       exporter_port=0)
    try:
        svc.detect("g0", as_input(True, ego(0)), tenant="a")
        svc.detect("g1", as_input(True, ego(1)), tenant="b")
        svc.drain()
        assert svc.frontend.exporter.url.startswith("http://127.0.0.1:")
        body = urllib.request.urlopen(
            svc.frontend.exporter.url, timeout=10).read().decode()
        parsed = parse_prometheus(body)
        names = metric_names(parsed)
        assert "repro_requests_served_total" in names
        assert "repro_span_duration_seconds_bucket" in names
        assert "repro_engine_compile_total" in names
        tenants = {dict(lk).get("tenant") for n, lk in parsed
                   if n == "repro_requests_served_total"}
        assert {"a", "b"} <= tenants
    finally:
        svc.close()
    assert svc.frontend.exporter is None


def test_replay_mini_run_reports_phase_breakdown():
    rep = run_replay(
        ReplayConfig(rate=40.0, duration_s=0.75, pool_size=4, n_tenants=3,
                     update_frac=0.3, seed=5),
        config(True, batch_size=4, max_delay_s=0.01), device="cpu")
    assert rep["offered"] > 0
    assert rep["served"] + rep["rejected"] + rep["failed"] >= rep["offered"]
    assert rep["failed"] == 0
    json.dumps(rep, allow_nan=False)
    bd = rep["phase_breakdown"]
    assert set(bd) == {"queue", "engine", "host"}
    assert sum(bd.values()) == pytest.approx(1.0)
    assert set(rep["phases"]) <= set(PHASES)
    good = dict(rate=10.0, goodput=1.0, p99_ms=5.0)
    bad = dict(rate=20.0, goodput=0.5, p99_ms=5.0)
    assert find_knee([good, bad]) == 20.0
    assert find_knee([good, dict(rate=20.0, goodput=1.0, p99_ms=100.0)]) \
        == 20.0
    assert find_knee([good]) is None


def test_replay_graph_pool_equals_the_reference():
    """The replay's pool: the reference's heavy-tailed sizes and graphs,
    built on the requested device."""
    from repro.service.replay import ReplayConfig as JConfig
    from repro.service.replay import build_graph_pool as j_pool

    kw = dict(pool_size=6, seed=3)
    pt, pj = build_graph_pool(ReplayConfig(**kw), device="cpu"), \
        j_pool(JConfig(**kw))
    assert len(pt) == len(pj)
    for a, b in zip(pt, pj):
        assert a.device.type == "cpu"
        for k in ("src", "dst", "w"):
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)))
        assert int(a.n_nodes) == int(b.n_nodes)
