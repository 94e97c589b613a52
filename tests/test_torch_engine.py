"""The batched engine of the PyTorch port (``repro_torch.service.engine``)
held against the JAX package's ``repro.service.engine`` and ``detect()``,
on the CPU.

The port's batch is a loop over its graphs, so each result must be the
reference's per-graph result: labels, ``n_communities``, ``passes``,
``sweeps``, ``split_moved``, ``n_disconnected`` and ``fraction`` bit for
bit, for every tier.  Q is the port's own fixed-order ``modularity``, held
to the reference within ``Q_ATOL`` (ROADMAP C.8).  The reference engine
compiles per bucket and tier, so it is run in a few cases only.  Mirrors
the engine cases of tests/test_service.py and tests/test_detect_api.py.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import Q_ATOL, _port

import repro.core as jcore
import repro.service as jservice
from repro.graph import sbm_graph
from repro.service.buckets import admit as j_admit
from repro_torch.core import DetectOptions, LouvainConfig
from repro_torch.core import api as t_api
from repro_torch.core import dynamic as t_dynamic
from repro_torch.core.modularity import modularity as t_modularity
from repro_torch.graph.container import strip_padding
from repro_torch.service import BatchedLouvainEngine, Bucket, ResultStore
from repro_torch.telemetry import InMemorySink, Telemetry

TIERS = ["fast", "standard", "max-quality"]
J_BUCKETS = (jservice.Bucket(64, 512), jservice.Bucket(64, 2048),
             jservice.Bucket(256, 2048))
FIELDS = ("C", "n_communities", "passes", "sweeps", "split_moved",
          "n_disconnected", "fraction")


def _ego(seed, n=30):
    return sbm_graph(n_nodes=n, n_blocks=3, p_in=0.4, p_out=0.04,
                     seed=seed)[0]


def _egos():
    """The five ego-nets of the reference's engine test, in its buckets."""
    return [j_admit(_ego(s), J_BUCKETS)[0] for s in range(5)]


def _sortscan_graph():
    """The (256, 1024) case of test_engine_sortscan_bucket_matches_louvain:
    density 0.016, under the crossover, so the sortscan."""
    g = sbm_graph(n_nodes=96, n_blocks=3, p_in=0.08, p_out=0.01, seed=5)[0]
    padded, b = j_admit(g, [jservice.Bucket(256, 1024)])
    assert (b.n_cap, b.m_cap) == (256, 1024)
    return padded


def _engine(**kw):
    return BatchedLouvainEngine(device="cpu", **kw)


def _own_q(g_port, C) -> float:
    live = strip_padding(g_port.src, g_port.dst, g_port.w, g_port.ghost)
    return float(t_modularity(*live, torch.from_numpy(C)))


def _check_against_detect(g_ref, g_port, r, algorithm):
    """One port result against the reference's ``detect()`` of the graph."""
    d = jcore.detect(g_ref, options=jcore.DetectOptions(algorithm=algorithm))
    np.testing.assert_array_equal(r.C, np.asarray(d.labels))
    st = d.stats
    assert (r.n_communities, r.passes, r.sweeps, r.split_moved,
            r.n_disconnected) == (
        d.n_communities, int(st["passes"]), int(st["li_total"]),
        int(st["split_moved"]), d.n_disconnected)
    frac = np.float32(d.n_disconnected) / np.float32(max(d.n_communities, 1))
    assert r.fraction == float(frac)
    assert r.q == _own_q(g_port, r.C)
    assert abs(r.q - d.modularity) <= Q_ATOL
    assert r.algorithm == algorithm and r.contract.tier == algorithm


def _same_results(a, b):
    for f in FIELDS:
        if f == "C":
            np.testing.assert_array_equal(a.C, np.asarray(b.C))
        else:
            assert getattr(a, f) == getattr(b, f), f


# ---------------------------------------------------------------------------
# the container and bucket helpers the engine imports
# ---------------------------------------------------------------------------

def _same_arrays(gt, gj):
    for name in ("src", "dst", "w", "n_nodes"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(),
                                      np.asarray(getattr(gj, name)),
                                      err_msg=name)
    assert (gt.n_cap, gt.m_cap) == (gj.n_cap, gj.m_cap)


def test_container_helpers_match_reference():
    from repro.graph import container as jc
    from repro_torch.graph import container as tc

    g = _ego(2)
    _same_arrays(tc.repad(_port(g), 64, 2048), jc.repad(g, 64, 2048))
    with pytest.raises(ValueError):
        tc.repad(_port(g), 16, 2048)
    _same_arrays(tc.unit_graph(64, 512, device="cpu"), jc.unit_graph(64, 512))
    for g in _egos()[:3]:                 # into a bucket's capacities
        _same_arrays(tc.repad(_port(g), 256, 2048), jc.repad(g, 256, 2048))


def test_bucket_helpers_match_reference():
    from repro.service import buckets as jb
    from repro_torch.service import buckets as tb

    for seed in range(3):
        g = _ego(seed, n=40 + 20 * seed)
        pj, bj = jb.admit(g, J_BUCKETS)
        pt, bt = tb.admit(_port(g), tuple(Bucket(b.n_cap, b.m_cap)
                                          for b in J_BUCKETS))
        assert (bt.n_cap, bt.m_cap) == (bj.n_cap, bj.m_cap)
        _same_arrays(pt, pj)
        assert tb.live_edges(pt) == jb.live_edges(pj)
        assert tb.bucket_of(pt) == bt
    _same_arrays(tb.filler(Bucket(64, 512), device="cpu"),
                 jb.filler(jservice.Bucket(64, 512)))
    with pytest.raises(ValueError):
        tb.admit(_port(_ego(0, n=300)), (Bucket(64, 512),))


# ---------------------------------------------------------------------------
# detect_batch against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", TIERS)
def test_engine_detect_batch_matches_reference_detect(algorithm):
    graphs = _egos()
    eng = _engine(options=DetectOptions(algorithm=algorithm))
    results = eng.detect_batch([_port(g) for g in graphs])
    assert len(results) == 5
    for g, r in zip(graphs, results):
        _check_against_detect(g, _port(g), r, algorithm)
        if algorithm != "fast":
            assert r.n_disconnected == 0


def test_engine_matches_reference_engine_batch():
    """One reference engine batch: every field of every result equal, Q
    within Q_ATOL."""
    graphs = _egos()
    want = jservice.BatchedLouvainEngine(jcore.LouvainConfig()).detect_batch(
        graphs)
    got = _engine(options=DetectOptions(louvain=LouvainConfig())).detect_batch(
        [_port(g) for g in graphs])
    for a, b in zip(got, want):
        _same_results(a, b)
        assert abs(a.q - b.q) <= Q_ATOL
        assert a.n_disconnected == 0


@pytest.mark.parametrize("algorithm", TIERS)
def test_engine_sortscan_bucket_matches_reference(algorithm):
    g = _sortscan_graph()
    eng = _engine(options=DetectOptions(algorithm=algorithm))
    assert eng.scan_for(Bucket(256, 1024)) == "sort"
    r = eng.detect_one(_port(g))
    _check_against_detect(g, _port(g), r, algorithm)
    if algorithm == "standard":
        C, stats = jcore.louvain(g, jcore.LouvainConfig())
        np.testing.assert_array_equal(r.C, np.asarray(C))
        assert r.n_communities == int(stats["n_communities"])


# ---------------------------------------------------------------------------
# dispatch keys, warm-up, keywords
# ---------------------------------------------------------------------------

def test_engine_compile_cache_reuse():
    """One key a (bucket, tier, scan), whatever the batch's size: the port
    pads no batch, so there is no tile ladder to key on."""
    graphs = [_port(g) for g in _egos()[:3]]
    eng = _engine()
    eng.detect_batch(graphs[:2])
    keys_after_first = set(eng.cache_keys())
    assert eng.last_detect_info.compile_hit is False
    eng.detect_batch(graphs[1:3])        # same bucket + tier
    assert set(eng.cache_keys()) == keys_after_first
    assert eng.last_detect_info.compile_hit is True
    assert (eng.n_compile_misses, eng.n_compile_hits) == (1, 1)
    eng.detect_batch(graphs[:3])         # a larger batch: the same key
    assert len(eng.cache_keys()) == 1
    assert eng.last_detect_info.n == 3
    eng.detect_batch(graphs[:1], algorithm="fast")   # another tier
    assert len(eng.cache_keys()) == 2
    assert (eng.n_compile_misses, eng.n_compile_hits) == (2, 2)


def test_engine_keys_match_reference_layout():
    """The reference's key without its tile count, sub-batch, seg_impl and
    block_m: (bucket, tier, scan), and (bucket, "update", tau, max_iters,
    tier, scan)."""
    b = Bucket(64, 512)
    jb = jservice.Bucket(64, 512)
    eng = _engine()
    jeng = jservice.BatchedLouvainEngine(sub_batch=2)
    for tiles, alg in ((1, None), (4, "max-quality")):
        key = eng._detect_key(b, alg)
        jkey = jeng._detect_key(jb, tiles, alg)
        assert key[0] == b and jkey[0] == jb
        assert key[1:] == jkey[3:-2]
    ukey = eng._update_key(b, 1e-3, 10)
    assert ukey[1:] == jeng._update_key(jb, 2, 1e-3, 10)[3:-2]
    assert eng.seg_block_for(b) == 0


def test_engine_options_vs_legacy_same_keys():
    """Equal options give equal keys, and the key IS the DetectOptions
    derivation.  The port has no legacy flat spelling: ``cfg=`` and the
    ``dense_*`` keywords are Python's own TypeError."""
    b = Bucket(64, 512)
    cfg = LouvainConfig(max_passes=3)
    eng = _engine(options=DetectOptions(louvain=cfg, dense_max_nv=513))
    same = _engine(options=DetectOptions(louvain=cfg).replace(
        dense_max_nv=513))
    assert eng.options == same.options
    assert eng._detect_key(b) == same._detect_key(b)
    assert eng._detect_key(b) == eng.options.cache_key(
        b, scan=eng.scan_for(b))
    for kw in (dict(cfg=cfg), dict(dense_max_nv=513),
               dict(dense_small_nv=65)):
        with pytest.raises(TypeError, match="unexpected keyword"):
            _engine(**kw)
        with pytest.raises(TypeError, match="unexpected keyword"):
            ResultStore(device="cpu", **kw)


@pytest.mark.parametrize("name", ["seg_impl", "block_m", "seg_block_m",
                                  "mesh"])
def test_keywords_without_counterpart_raise(name):
    """The reference's knobs without a port field are not accepted, so
    they are never ignored."""
    value = {"seg_impl": "xla", "block_m": 128, "seg_block_m": 128,
             "mesh": 2}[name]
    g = _port(_egos()[0])
    with pytest.raises(TypeError, match="unexpected keyword"):
        t_api.detect(g, device="cpu", **{name: value})
    with pytest.raises(TypeError):
        DetectOptions(**{name: value})
    with pytest.raises(TypeError, match="unexpected keyword"):
        _engine(**{name: value})
    with pytest.raises(TypeError, match="unexpected keyword"):
        ResultStore(device="cpu", **{name: value})


def test_warm_runs_the_tile_ladder_once():
    """The ladder is one rung: one filler graph a new (bucket, tier) key,
    and one filler update a new update key."""
    eng = _engine(algorithms=("standard", "fast"))
    b = Bucket(64, 512)
    assert eng.warm(b) == 2               # one dispatch for each tier
    assert eng.warm(b) == 0               # every key dispatched already
    assert len(eng.cache_keys()) == 2
    assert eng.last_detect_info.n == 1
    assert eng.warm_updates(b) == 1
    assert eng.warm_updates(b) == 0
    assert len(eng.cache_keys()) == 3
    assert eng.last_update_info.n == 1
    r = eng.detect_batch([_port(g) for g in _egos()[:3]], algorithm="fast")
    assert eng.last_detect_info.compile_hit and len(r) == 3


def test_engine_telemetry_reaches_sink():
    sink = InMemorySink()
    hub = Telemetry()
    hub.register(sink)
    eng = _engine(telemetry=hub)
    graphs = [_port(g) for g in _egos()[:2]]
    first = eng.detect_batch(graphs)
    eng.detect_batch(graphs)
    results = {(n, dict(lk)["result"]): v for (n, lk), v in
               sink.counters.items() if n == "engine_compile"}
    assert results == {("engine_compile", "miss"): 1,
                       ("engine_compile", "hit"): 1}
    assert sink.counter_total("louvain_passes") == 2 * sum(
        r.passes for r in first)
    assert sink.counter_total("local_move_sweeps") == 2 * sum(
        r.sweeps for r in first)
    assert sink.counter_total("split_moves") == 2 * sum(
        r.split_moved for r in first)
    # no batch is padded, so there is no fill factor to report
    assert not [n for (n, _) in sink.gauges if n == "batch_fill_factor"]


class _FaultStub:
    """A duck-typed fault plan: records every seam it is consulted at."""

    def __init__(self):
        self.calls = []

    def perturb(self, name, ids=None):
        self.calls.append((name, None if ids is None else tuple(ids)))


def test_faults_called_at_the_seams_and_bypassed_by_warm():
    stub = _FaultStub()
    eng = _engine(faults=stub)
    b = Bucket(64, 512)
    eng.warm(b)
    eng.warm_updates(b)
    assert stub.calls == [] and eng.faults is stub
    g = _port(_egos()[0])
    eng.detect_batch([g], fault_ids=["g0"])
    nv = g.nv
    eng.update_batch([(g, np.arange(nv, dtype=np.int32),
                       np.zeros(nv, bool))], fault_ids=["g0"])
    assert stub.calls == [("engine.detect.hang", ("g0",)),
                          ("engine.detect", ("g0",)),
                          ("engine.update.hang", ("g0",)),
                          ("engine.update", ("g0",))]


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedLouvainEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResultStore()
    assert _engine().device.type == "cpu"


def test_detect_sharded_waits_for_a12():
    with pytest.raises(NotImplementedError, match="item 12"):
        _engine().detect_sharded(_port(_egos()[0]))


def test_mixed_buckets_rejected():
    g1 = _port(_egos()[0])
    g2 = _port(_sortscan_graph())
    with pytest.raises(ValueError, match="homogeneous"):
        _engine().detect_batch([g1, g2])


# ---------------------------------------------------------------------------
# update_batch against the reference engine and the immediate path
# ---------------------------------------------------------------------------

def _stores(scan):
    """A reference and a port store holding the same four entries: the
    ego-nets at the reference's standard labels."""
    js = jservice.ResultStore(options=jcore.DetectOptions(scan=scan))
    ts = ResultStore(options=DetectOptions(scan=scan), device="cpu")
    for i, g in enumerate(_egos()[:4]):
        d = jcore.detect(g)
        for store, gg in ((js, g), (ts, _port(g))):
            store.put(f"g{i}", gg, np.asarray(d.labels),
                      n_communities=d.n_communities,
                      n_disconnected=d.n_disconnected, q=d.modularity)
    return js, ts


def _churn(seed=2):
    """One batch a graph: edge insertions, and vertex additions and
    removals on some (reference and port spellings)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, g in enumerate(_egos()[:4]):
        n = int(g.n_nodes)
        u, v = rng.integers(0, n, 4), rng.integers(0, n, 4)
        keep = u != v
        kw = dict(u=u[keep], v=v[keep],
                  dw=np.ones(int(keep.sum()), np.float32),
                  add=i % 2, remove=[i + 1] if i >= 2 else [])
        out.append((jcore.GraphUpdate(**kw), t_dynamic.GraphUpdate(**kw)))
    return out


@pytest.mark.parametrize("scan", ["sort", "dense"])
def test_update_batch_matches_reference_engine_and_immediate(scan):
    js, ts = _stores(scan)
    churn = _churn()
    items_j, items_t = [], []
    for i, (uj, ut) in enumerate(churn):
        pj, pt = js.prepare_update(f"g{i}", uj), ts.prepare_update(f"g{i}",
                                                                   ut)
        for name in ("src", "dst", "w", "n_nodes"):
            np.testing.assert_array_equal(
                getattr(pt.graph, name).numpy(),
                np.asarray(getattr(pj.graph, name)), err_msg=name)
        np.testing.assert_array_equal(pt.C_prev, pj.C_prev)
        np.testing.assert_array_equal(pt.touched, pj.touched)
        items_j.append((pj.graph, pj.C_prev, pj.touched))
        items_t.append((pt.graph, pt.C_prev, pt.touched))
    want = jservice.BatchedLouvainEngine(
        options=jcore.DetectOptions(scan=scan)).update_batch(items_j)
    eng = _engine(options=DetectOptions(scan=scan))
    assert eng.scan_for(Bucket(64, 512)) == scan
    got = eng.update_batch(items_t)
    info = eng.last_update_info
    assert (info.kind, info.n) == ("update", 4)
    _, immediate = _stores(scan)         # a second store: the immediate path
    for i, (a, b, (g, _, _)) in enumerate(zip(got, want, items_t)):
        np.testing.assert_array_equal(a.C, np.asarray(b.C))
        for f in ("n_communities", "n_disconnected", "fraction",
                  "iterations", "n_affected", "split_moved"):
            assert getattr(a, f) == getattr(b, f), (i, f)
        assert a.q == _own_q(g, a.C)
        assert abs(a.q - b.q) <= Q_ATOL
        assert a.n_disconnected == 0
        e = immediate.apply_update(f"g{i}", churn[i][1])
        np.testing.assert_array_equal(e.C, a.C)
        assert (e.n_communities, e.n_disconnected, e.q) == (
            a.n_communities, a.n_disconnected, a.q)
