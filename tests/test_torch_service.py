"""The front end of the PyTorch port (``repro_torch.service``:
``ServiceConfig``, ``ServiceFrontend`` and the sync adapter
``CommunityService``) held against the JAX package's, on the CPU.

Each case runs one scenario, built from numpy seeds, through both
packages with a scripted clock, so nothing depends on the wall clock: the
entries are equal (graph, labels, counts, version, bucket, tier; Q within
``Q_ATOL``, ROADMAP C.8), and so are the request ids, the batches the DRR
composes in their order, each trace's span names in order and the metrics
reports.  A detect entry is also the port's own ``detect()`` of its
admitted graph, Q's bits included.  Mirrors the front-end cases of
tests/test_service.py and tests/test_dynamic_vertices.py.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_service import (
    FakeClock, as_input, config, ego, edge_updates, frontend,
    overflow_updates, q_is_detect, record_batches, report_counts,
    same_entry, span_names, sync_service,
)

import repro.service as jservice
from repro.core import GraphUpdate as JUpdate
from repro.graph import sbm_graph
import repro_torch.service as tservice
from repro_torch.core import GraphUpdate as TUpdate
from repro_torch.service.frontend import DetectionFuture, _chain

BOTH = (True, False)


def _both(run):
    """``run(port)`` for the port, then the reference."""
    return run(True), run(False)


# ---------------------------------------------------------------------------
# ServiceConfig: the reference's fields, defaults and messages, no legacy
# ---------------------------------------------------------------------------

BAD_CONFIGS = [
    dict(batch_size=0),
    dict(update_batch_size=0),
    dict(max_pending_per_tenant=0),
    dict(tenant_weights=(("a", 0.0),)),
    dict(telemetry_enabled=False, exporter_port=0),
    dict(compact_window=-1),
    dict(timeline_jaccard_min=0.0),
    dict(timeline_max_rows=0),
    dict(degrade_modes=("lpa", "later")),
    dict(degrade_modes=()),
    dict(autockpt_period_s=0.0),
    dict(autockpt_dirty=-1),
    dict(autockpt_keep=0),
    dict(autockpt_writeback=-1),
    dict(tenant_tiers=(("a", "balanced"),)),
    dict(deadline_tiers=(("fast", 0.5), ("standard", 0.5))),
]


@pytest.mark.parametrize("kw", BAD_CONFIGS,
                         ids=[",".join(k) for k in BAD_CONFIGS])
def test_service_config_validation(kw):
    msgs = []
    for S in (tservice, jservice):
        with pytest.raises(ValueError) as ei:
            S.ServiceConfig(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_service_config_defaults_and_tiers_equal_the_reference():
    cfg = config(True, buckets=((256, 2048), (64, 512)))
    assert [(b.n_cap, b.m_cap) for b in cfg.buckets] == [(64, 512),
                                                         (256, 2048)]
    t, j = tservice.ServiceConfig(), jservice.ServiceConfig()
    skip = {"detect", "buckets"}
    for f in t.__dataclass_fields__:
        if f not in skip:
            assert getattr(t, f) == getattr(j, f), f
    assert [(b.n_cap, b.m_cap) for b in t.buckets] == \
        [(b.n_cap, b.m_cap) for b in j.buckets]
    kw = dict(tenant_tiers=(("cheap", "fast"), ("vip", "max-quality")),
              deadline_tiers=(("fast", 0.05), ("standard", 1.0)))
    t, j = tservice.ServiceConfig(**kw), jservice.ServiceConfig(**kw)
    assert t.serve_algorithms == j.serve_algorithms
    for args in [dict(tenant="cheap"), dict(tenant="vip", deadline_s=0.01),
                 dict(deadline_s=0.01), dict(deadline_s=0.5),
                 dict(deadline_s=5.0), dict(), dict(algorithm="fast"),
                 dict(tenant="cheap", algorithm="standard")]:
        assert t.tier_for(**args) == j.tier_for(**args), args
    with pytest.raises(ValueError):
        t.tier_for(algorithm="balanced")


LEGACY = ["louvain", "dense_max_nv", "dense_small_nv",
          "dense_min_density", "seg_impl", "seg_block_m"]


@pytest.mark.parametrize("name", LEGACY)
def test_service_config_legacy_keywords_raise(name):
    """The reference's deprecated flat keywords are not fields of the
    port's config: Python's own TypeError."""
    with pytest.raises(TypeError, match=name):
        tservice.ServiceConfig(**{name: None})
    assert not hasattr(tservice.ServiceConfig(), name)


@pytest.mark.parametrize("sub_batch", [None, 1, 3])
def test_service_config_sub_batch_reaches_the_engine(sub_batch):
    """``ServiceConfig.sub_batch``, the reference's field and default,
    reaches the front end's engine as the reference's does (``None``: the
    auto width, 1 on the CPU, as the reference's on its CPU backend)."""
    widths = []
    for S, kw in ((tservice, dict(device="cpu")), (jservice, {})):
        cfg = S.ServiceConfig(sub_batch=sub_batch)
        assert cfg.sub_batch == sub_batch
        fe = S.ServiceFrontend(cfg, **kw)
        widths.append(fe.engine.sub_batch)
        fe.close()
    assert widths[0] == widths[1] == (sub_batch or 1)


def test_community_service_dropped_keywords_raise():
    with pytest.raises(TypeError, match="dense_max_nv"):
        tservice.CommunityService(device="cpu", dense_max_nv=4)


@pytest.mark.parametrize("sub_batch", [2, 4])
def test_community_service_sub_batch_runs_tiles(sub_batch):
    """``CommunityService(sub_batch=...)`` reaches the engine, whose
    standard batches on the dense scan run in tiles of that width, each
    entry the port's own ``detect()`` of its admitted graph."""
    svc = tservice.CommunityService(device="cpu", sub_batch=sub_batch,
                                    batch_size=5, max_delay_s=0.0,
                                    clock=FakeClock())
    assert svc.engine.sub_batch == sub_batch
    for i in range(5):
        svc.submit_detect(f"g{i}", as_input(True, ego(i)))
    svc.drain()
    info = svc.engine.last_detect_info
    assert info.route == "tile" and info.n == 5
    assert info.capacity == -(-5 // sub_batch) * sub_batch
    for i in range(5):
        e = svc.result(f"g{i}")
        assert e.n_disconnected == 0
        q_is_detect(e)
    svc.close()


def test_front_ends_raise_without_cuda_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: device=None resolves to it")
    for make in (lambda: tservice.ServiceFrontend(tservice.ServiceConfig()),
                 lambda: tservice.CommunityService(),
                 lambda: tservice.AsyncCommunityService()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    fe = tservice.ServiceFrontend(device="cpu")
    assert fe.device.type == fe.engine.device.type == \
        fe.store.device.type == "cpu"
    fe.close()


# ---------------------------------------------------------------------------
# the sync adapter end to end
# ---------------------------------------------------------------------------

def _mixed(port):
    clock = FakeClock()
    svc = sync_service(port, clock=clock, batch_size=4, max_delay_s=10.0)
    log = record_batches(svc.frontend)
    small = [ego(s) for s in range(4)]                      # (64, 512)
    big = [sbm_graph(n_nodes=100, n_blocks=4, p_in=0.2, p_out=0.02,
                     seed=s)[0] for s in range(2)]          # (256, 2048)
    ids = [svc.submit_detect(f"s{i}", as_input(port, g))
           for i, g in enumerate(small)]
    ids += [svc.submit_detect(f"b{i}", as_input(port, g), tenant="big")
            for i, g in enumerate(big)]
    clock.advance(0.5)
    served = svc.drain()
    buckets = len({k[0] for k in svc.engine.cache_keys()})
    routed = []
    for gid in ["s0", "b0"]:
        e = svc.result(gid)
        n = int(e.graph.n_nodes)
        rng = np.random.default_rng(1)
        routed.append(svc.submit_update(
            gid, (rng.integers(0, n, 4), rng.integers(0, n, 4),
                  np.ones(4, np.float32))))
        clock.advance(0.25)
    entries = {g: svc.result(g) for g in ["s0", "s1", "s2", "s3", "b0",
                                          "b1"]}
    return dict(ids=ids, served=served, buckets=buckets, routed=routed,
                log=log, entries=entries, report=report_counts(svc.metrics))


def test_service_mixed_buckets_and_updates():
    t, j = _both(_mixed)
    assert t["served"] == j["served"] == 6
    assert t["buckets"] == j["buckets"] == 2
    assert t["routed"] == j["routed"] == [True, True]
    assert t["ids"] == j["ids"]
    assert t["log"] == j["log"]                  # DRR batches, in order
    for gid, e in t["entries"].items():
        same_entry(e, j["entries"][gid])
        assert e.n_disconnected == 0
        if gid in ("s1", "s2", "s3", "b1"):
            q_is_detect(e)
    assert t["entries"]["s0"].version == 2
    assert t["report"] == j["report"]
    rep = t["report"]
    assert rep["n_detect"] == 6 and rep["n_update"] == 2
    assert rep["tenants"]["default"]["served"] == 6


def test_rebucket_update_exempt_from_queue_bound():
    def run(port):
        fe = frontend(port, batch_size=2, max_delay_s=10.0,
                      max_pending_per_tenant=1, clock=FakeClock())
        fe.submit_detect("g", as_input(port, ego(9)), tenant="a")
        fe.dispatch(force=True)
        e = fe.result("g")
        fe.submit_detect("other", as_input(port, ego(1)), tenant="a")
        S = tservice if port else jservice
        with pytest.raises(S.QueueFull):
            fe.submit_detect("third", as_input(port, ego(2)), tenant="a")
        fut = fe.submit_update("g", overflow_updates(e.graph), tenant="a")
        assert fut.kind == "detect"
        fe.drain()
        return fut, fe

    (ft, fet), (fj, fej) = _both(run)
    assert ft.result().version == fj.result().version == 2
    same_entry(ft.result(), fj.result())
    same_entry(fet.result("other"), fej.result("other"))
    q_is_detect(ft.result())
    assert ft.req_id == fj.req_id
    assert span_names(ft) == span_names(fj)
    assert report_counts(fet.metrics) == report_counts(fej.metrics)


def _update_graphs():
    graphs = [ego(s) for s in range(4)]
    rng = np.random.default_rng(2)
    upds = []
    for g in graphs:
        n = int(g.n_nodes)
        u, v = rng.integers(0, n, 4), rng.integers(0, n, 4)
        keep = u != v
        upds.append((u[keep], v[keep],
                     np.ones(int(keep.sum()), np.float32)))
    return graphs, upds


def test_batched_updates_match_immediate_path():
    graphs, upds = _update_graphs()

    def serve(port, update_batch_size):
        svc = sync_service(port, clock=FakeClock(), batch_size=4,
                           max_delay_s=10.0,
                           update_batch_size=update_batch_size)
        for i, g in enumerate(graphs):
            svc.submit_detect(f"g{i}", as_input(port, g))
        svc.drain()
        log = record_batches(svc.frontend)
        for i, upd in enumerate(upds):
            svc.submit_update(f"g{i}", upd)
        svc.drain()
        return svc, log

    a, _ = serve(True, 1)
    b, log_b = serve(True, 4)
    jb, log_j = serve(False, 4)
    assert b.metrics.n_update_batches == jb.metrics.n_update_batches >= 1
    assert a.metrics.n_update_batches == 0
    assert log_b == log_j
    for i in range(4):
        ea, eb = a.result(f"g{i}"), b.result(f"g{i}")
        np.testing.assert_array_equal(ea.C, eb.C)
        assert ea.q == eb.q and ea.n_communities == eb.n_communities
        assert ea.version == eb.version == 2
        assert eb.n_disconnected == 0
        same_entry(eb, jb.result(f"g{i}"))
    assert report_counts(b.metrics) == report_counts(jb.metrics)


def test_batched_update_rebucket_chains_future():
    def run(port):
        fe = frontend(port, batch_size=2, max_delay_s=10.0,
                      update_batch_size=2, clock=FakeClock())
        fe.submit_detect("g", as_input(port, ego(9)), tenant="a")
        fe.dispatch(force=True)
        e = fe.result("g")
        fut = fe.submit_update("g", overflow_updates(e.graph), tenant="a")
        assert fut.kind == "update" and not fut.done()
        assert fe.pending_updates() == 1
        fe.drain()
        assert fut.done()
        assert fe.metrics.n_rebucketed == 1
        assert fe.result("g").bucket != e.bucket
        return fut

    ft, fj = _both(run)
    assert ft.result().version == 2 and ft.result().n_disconnected == 0
    same_entry(ft.result(), fj.result())
    q_is_detect(ft.result())
    assert span_names(ft) == span_names(fj)


def test_batched_update_merges_same_graph_deltas():
    def run(port):
        fe = frontend(port, batch_size=2, max_delay_s=10.0,
                      update_batch_size=2, clock=FakeClock())
        fe.submit_detect("g", as_input(port, ego(4)), tenant="a")
        fe.dispatch(force=True)
        e1 = fe.result("g")
        lu, lv, lw = (np.asarray(x) for x in (e1.graph.src, e1.graph.dst,
                                              e1.graph.w))
        live = (lu < e1.graph.n_cap) & (lu < lv)
        u0, v0, w0 = int(lu[live][0]), int(lv[live][0]), float(lw[live][0])
        f1 = fe.submit_update("g", (np.array([u0]), np.array([v0]),
                                    np.array([2.0], np.float32)))
        f2 = fe.submit_update("g", (np.array([u0]), np.array([v0]),
                                    np.array([-(w0 + 2.0)], np.float32)))
        fe.drain()
        assert f1.result() is f2.result()
        assert f1.result().version == 2
        g2 = fe.result("g").graph
        s2, d2 = np.asarray(g2.src), np.asarray(g2.dst)
        assert not ((s2 == u0) & (d2 == v0)).any()
        assert fe.metrics.n_deletions >= 2
        return f1, fe

    (ft, fet), (fj, fej) = _both(run)
    same_entry(ft.result(), fj.result())
    assert report_counts(fet.metrics) == report_counts(fej.metrics)


def test_batched_fold_matches_immediate_clamping():
    def run(port, update_batch_size):
        fe = frontend(port, batch_size=2, max_delay_s=10.0,
                      update_batch_size=update_batch_size,
                      clock=FakeClock())
        fe.submit_detect("g", as_input(port, ego(4)), tenant="a")
        fe.dispatch(force=True)
        e = fe.result("g")
        lu, lv = np.asarray(e.graph.src), np.asarray(e.graph.dst)
        live = (lu < e.graph.n_cap) & (lu < lv)
        u0, v0 = int(lu[live][0]), int(lv[live][0])
        fe.submit_update("g", (np.array([u0]), np.array([v0]),
                               np.array([-5.0], np.float32)))
        fe.submit_update("g", (np.array([u0]), np.array([v0]),
                               np.array([3.0], np.float32)))
        fe.drain()
        g2 = fe.result("g").graph
        s2, d2, w2 = (np.asarray(g2.src), np.asarray(g2.dst),
                      np.asarray(g2.w))
        hit = (s2 == u0) & (d2 == v0)
        return (float(w2[hit][0]) if hit.any() else None), fe.result("g")

    (w1, e1), (w2, e2) = run(True, 1), run(True, 2)
    assert w1 == w2 == 3.0
    np.testing.assert_array_equal(e1.C, e2.C)
    _, ej = run(False, 2)
    same_entry(e2, ej)


def test_chained_future_cancellation_propagates():
    src = DetectionFuture("d0-g", "a", "g", "detect", 0.0)
    dst = DetectionFuture("u0-g", "a", "g", "update", 0.0)
    _chain(src, dst)
    src.cancel()
    assert dst.done()
    with pytest.raises(Exception):      # CancelledError
        dst.result(timeout=1.0)
    # a result and an exception cross the chain as they are
    for outcome in ("result", "exception"):
        a = DetectionFuture("d1-g", "a", "g", "detect", 0.0)
        b = DetectionFuture("u1-g", "a", "g", "update", 0.0)
        _chain(a, b)
        if outcome == "result":
            a.set_result("entry")
            assert b.result(timeout=1.0) == "entry"
        else:
            a.set_exception(KeyError("gone"))
            assert isinstance(b.exception(timeout=1.0), KeyError)


def test_request_ids_monotonic_across_dispatch():
    def run(port):
        svc = sync_service(port, clock=FakeClock(), batch_size=1,
                           max_delay_s=10.0)
        ids = [svc.submit_detect("g", as_input(port, ego(0)))]
        svc.drain()
        ids.append(svc.submit_detect("g", as_input(port, ego(0))))
        svc.pump(force=True)
        ids.append(svc.submit_detect("g", as_input(port, ego(0))))
        svc.drain()
        return ids, svc.result("g")

    (it, et), (ij, ej) = _both(run)
    assert it == ij and len(set(it)) == len(it)
    assert et.version == 3
    same_entry(et, ej)


# ---------------------------------------------------------------------------
# vertex updates through the front end (tests/test_dynamic_vertices.py)
# ---------------------------------------------------------------------------

def _vertex_graphs():
    return [sbm_graph(n_nodes=36 + i, n_blocks=3, seed=i)[0]
            for i in range(4)]


def test_frontend_batched_vertex_updates_match_immediate():
    def run(port, batched):
        U = TUpdate if port else JUpdate
        svc = sync_service(port, clock=FakeClock(), batch_size=4,
                           max_delay_s=0.01,
                           update_batch_size=4 if batched else 1,
                           buckets=((64, 512), (64, 2048), (256, 2048),
                                    (256, 8192), (1024, 16384)))
        for i, g in enumerate(_vertex_graphs()):
            svc.submit_detect(f"g{i}", as_input(port, g))
        svc.drain()
        futs = []
        for i in range(4):
            e = svc.result(f"g{i}")
            n = int(e.graph.n_nodes)
            C = np.asarray(e.C)
            peers = [k - (k > 1) for k in range(n)
                     if C[k] == C[0] and k != 1][:2]
            upd = U(u=np.full(len(peers), n - 1), v=np.array(peers),
                    dw=np.ones(len(peers), np.float32), add=1,
                    remove=np.array([1]))
            futs.append(svc.frontend.submit_update(f"g{i}", upd))
        svc.drain()
        return [f.result(timeout=5) for f in futs], svc.metrics

    (bt, mt), (it, _) = run(True, True), run(True, False)
    bj, mj = run(False, True)
    for i, (eb, ei) in enumerate(zip(bt, it)):
        np.testing.assert_array_equal(eb.C, ei.C)
        assert eb.q == ei.q and eb.n_disconnected == 0
        same_entry(eb, bj[i])
    assert mt.n_update_batches >= 1
    assert mt.n_vertex_added == mt.n_vertex_removed == 4
    assert report_counts(mt) == report_counts(mj)


def test_frontend_vertex_overflow_rebuckets():
    def run(port):
        U = TUpdate if port else JUpdate
        svc = sync_service(port, clock=FakeClock(), batch_size=2,
                           max_delay_s=0.01,
                           buckets=((64, 512), (64, 2048), (256, 2048),
                                    (256, 8192), (1024, 16384)))
        svc.submit_detect("big", as_input(port, sbm_graph(
            n_nodes=62, n_blocks=3, seed=5)[0]))
        svc.drain()
        e0 = svc.result("big")
        assert e0.bucket.n_cap == 64
        assert not svc.submit_update("big", U(add=10))
        svc.drain()
        e1 = svc.result("big")
        assert e1.bucket.n_cap > 64 and int(e1.graph.n_nodes) == 72
        assert e1.n_disconnected == 0 and e1.version > e0.version
        assert svc.metrics.n_rebucketed == 1
        return e1

    et, ej = _both(run)
    same_entry(et, ej)
    q_is_detect(et)
