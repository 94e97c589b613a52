"""The result store of the PyTorch port (``repro_torch.service.store``)
held against the JAX package's ``repro.service.store``, on the CPU.

The same calls go to a reference store and a port store, and after each
the entries must agree: the graph arrays, labels, version, counts,
deferred tombstones and tier; Q within ``Q_ATOL`` of the reference and
equal to the port's own ``modularity`` (ROADMAP C.8).  Plans of the
prepare half (``prepare_update_seq``, deferred compaction) are compared
field by field.  Mirrors the store cases of tests/test_service.py and
``test_store_options_fold`` of tests/test_detect_api.py.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import Q_ATOL, _port

import repro.core as jcore
import repro.service as jservice
from repro.core import dynamic as jd
from repro.graph import sbm_graph
from repro.service.buckets import admit as j_admit
from repro_torch.core import DetectOptions
from repro_torch.core import dynamic as td
from repro_torch.core.modularity import modularity as t_modularity
from repro_torch.graph.container import strip_padding
from repro_torch.service import (BatchedLouvainEngine, CapacityExceeded,
                                 OptionsMismatch, ResultStore)
from tests._service_helpers import overflow_updates

J_BUCKETS = (jservice.Bucket(64, 512), jservice.Bucket(64, 2048),
             jservice.Bucket(256, 2048))


def _ego(seed, n=30):
    g = sbm_graph(n_nodes=n, n_blocks=3, p_in=0.4, p_out=0.04, seed=seed)[0]
    return j_admit(g, J_BUCKETS)[0]


class Pair:
    """A reference store and a port store, driven by the same calls."""

    def __init__(self, **kw):
        self.ref = jservice.ResultStore(**kw)
        self.port = ResultStore(device="cpu", **kw)
        self.ref_hook, self.port_hook = [], []
        self.ref.on_commit = lambda gid, e, p: self.ref_hook.append(
            (gid, e.version, p is None))
        self.port.on_commit = lambda gid, e, p: self.port_hook.append(
            (gid, e.version, p is None))

    def put(self, gid, g, **kw):
        """Both stores take the reference's detection of ``g``."""
        d = jcore.detect(g, **kw)
        alg = kw["options"].algorithm if "options" in kw else None
        for store, gg in ((self.ref, g), (self.port, _port(g))):
            store.put(gid, gg, np.asarray(d.labels),
                      n_communities=d.n_communities,
                      n_disconnected=d.n_disconnected, q=d.modularity,
                      algorithm=alg)

    def call(self, name, *args, port_args=None, **kw):
        """The same method on both stores; both raise the same exception
        type or both return."""
        out = []
        for store, a in ((self.ref, args), (self.port, port_args or args)):
            try:
                out.append(getattr(store, name)(*a, **kw))
            except Exception as e:                        # noqa: BLE001
                out.append(type(e).__name__)
        if isinstance(out[0], str) or isinstance(out[1], str):
            assert out[0] == out[1], out
        return out

    def check(self, gid):
        """The two entries agree (or both are absent), as do the stores'
        counters and commit-hook calls."""
        a, b = self.port.get(gid), self.ref.get(gid)
        assert (a is None) == (b is None), gid
        for name in ("n_warm_updates", "n_invalidations", "n_evicted",
                     "n_expired", "n_deletions", "n_vertex_added",
                     "n_vertex_removed", "n_stale_commits",
                     "n_deferred_removed", "n_compaction_flushes"):
            assert getattr(self.port, name) == getattr(self.ref, name), name
        assert self.port_hook == self.ref_hook
        assert len(self.port) == len(self.ref)
        assert self.port.graph_ids() == self.ref.graph_ids()
        if a is None:
            return
        for name in ("src", "dst", "w", "n_nodes"):
            np.testing.assert_array_equal(
                getattr(a.graph, name).numpy(),
                np.asarray(getattr(b.graph, name)), err_msg=name)
        np.testing.assert_array_equal(a.C, np.asarray(b.C))
        np.testing.assert_array_equal(a.deferred, b.deferred)
        assert (a.version, a.n_communities, a.n_disconnected, a.algorithm,
                a.n_live_communities) == (
            b.version, b.n_communities, b.n_disconnected, b.algorithm,
            b.n_live_communities)
        assert (a.bucket.n_cap, a.bucket.m_cap) == (b.bucket.n_cap,
                                                    b.bucket.m_cap)
        assert a.cache_key == self.port.options.result_key(a.algorithm)
        assert abs(a.q - b.q) <= Q_ATOL
        if self.port.n_warm_updates and not a.deferred.size:
            live = strip_padding(a.graph.src, a.graph.dst, a.graph.w,
                                 a.graph.ghost)
            assert a.q == float(t_modularity(*live, torch.from_numpy(a.C)))


def _edges(g, seed, k=5):
    rng = np.random.default_rng(seed)
    n = int(g.n_nodes)
    return rng.integers(0, n, k), rng.integers(0, n, k), np.ones(
        k, np.float32)


def _both(upd: jd.GraphUpdate):
    """A reference update and the port's spelling of it."""
    return upd, td.GraphUpdate(u=upd.u, v=upd.v, dw=upd.dw, add=upd.add,
                               remove=upd.remove)


# ---------------------------------------------------------------------------
# the cases of tests/test_service.py
# ---------------------------------------------------------------------------

def test_store_update_routes_through_warm_path():
    g = _ego(7)
    pair = Pair()
    pair.put("g", g)
    pair.check("g")
    assert pair.port.get("g").version == 1
    pair.call("apply_update", "g", _edges(g, 0))
    pair.check("g")
    entry = pair.port.get("g")
    assert entry.version == 2 and pair.port.n_warm_updates == 1
    assert entry.n_disconnected == 0            # guarantee survives updates
    assert float(entry.graph.total_weight_2m()) > float(
        _port(g).total_weight_2m())
    # the port's engine gives the same detection for the first put
    r = BatchedLouvainEngine(device="cpu").detect_one(_port(g))
    assert r.n_disconnected == 0


def test_store_capacity_overflow_invalidates():
    g = _ego(9)
    pair = Pair()
    pair.put("g", g)
    out = pair.call("apply_update", "g", overflow_updates(g))
    assert out == ["CapacityExceeded", "CapacityExceeded"]
    assert pair.port.get("g") is None           # invalidated
    pair.check("g")
    assert pair.port.n_invalidations == 1


def test_store_lru_eviction_and_ttl():
    t = [0.0]
    pair = Pair(max_entries=2, ttl_s=10.0, clock=lambda: t[0])
    g = _ego(1)
    C = np.zeros(g.nv, np.int32)

    def put(gid):
        return pair.call("put", gid, g, C, port_args=(gid, _port(g), C),
                         n_communities=1, n_disconnected=0, q=0.0)

    put("a")
    put("b")
    pair.call("get", "a")               # refresh a's recency
    put("c")                            # evicts b (LRU), not a
    for gid in "abc":
        pair.check(gid)
    assert pair.port.get("b") is None and pair.port.get("a") is not None
    assert pair.port.n_evicted == 1 and len(pair.port) == 2
    t[0] = 11.0                         # past ttl for both residents
    assert pair.port.get("a") is None and pair.ref.get("a") is None
    assert pair.port.n_expired == 1
    a, b = put("b")                     # versions stay monotone
    assert a.version == b.version == 2
    t[0] = 30.0
    out = pair.call("apply_update", "b", (np.array([0]), np.array([1]),
                                          np.ones(1, np.float32)))
    assert out == ["KeyError", "KeyError"]
    pair.check("b")


def test_store_options_fold():
    """The store takes its options as one record (the reference folds its
    flat keywords into the same record; the port has no flat spelling)."""
    new = ResultStore(options=DetectOptions(dense_max_nv=513), device="cpu")
    ref = jservice.ResultStore(
        options=jcore.DetectOptions(dense_max_nv=513))
    assert new.options.dense_max_nv == ref.options.dense_max_nv == 513
    assert ResultStore(device="cpu").options == DetectOptions()
    for kw in (dict(dense_max_nv=513), dict(seg_impl="scatter")):
        with pytest.raises(TypeError, match="unexpected keyword"):
            ResultStore(device="cpu", **kw)


def test_store_refuses_cross_tier_warm_update():
    g = _ego(3)
    pair = Pair()
    pair.put("g", g, options=jcore.DetectOptions(algorithm="fast"))
    pair.check("g")
    out = pair.call("prepare_update", "g", _edges(g, 1))
    assert out == ["OptionsMismatch", "OptionsMismatch"]
    assert issubclass(OptionsMismatch, CapacityExceeded)
    pair.check("g")                      # invalidated in both


# ---------------------------------------------------------------------------
# prepare_update_seq, deferred compaction, stale commits
# ---------------------------------------------------------------------------

def _plans_equal(a, b):
    for name in ("src", "dst", "w", "n_nodes"):
        np.testing.assert_array_equal(getattr(a.graph, name).numpy(),
                                      np.asarray(getattr(b.graph, name)),
                                      err_msg=name)
    for name in ("C_prev", "touched", "deferred_removed", "deferred_after"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert (a.id_map is None) == (b.id_map is None)
    if a.id_map is not None:
        np.testing.assert_array_equal(a.id_map, b.id_map)
    assert (a.graph_id, a.scan, a.n_deleted, a.version, a.n_added,
            a.n_removed, a.n_flushed) == (
        b.graph_id, b.scan, b.n_deleted, b.version, b.n_added, b.n_removed,
        b.n_flushed)


def _commit_both(pair, plans, scan):
    """Run the warm update of each package on its own plan, commit it."""
    pj, pt = plans
    out = jd.warm_update(pj.graph, pj.C_prev, pj.touched, scan=scan)
    pair.ref.commit_update(pj, C=np.asarray(out["C"]),
                           n_communities=int(out["n_communities"]),
                           n_disconnected=int(out["n_disconnected"]),
                           q=float(out["q"]))
    o = td.warm_update(pt.graph, torch.tensor(pt.C_prev),
                       torch.tensor(pt.touched), scan=scan)
    pair.port.commit_update(pt, C=o["C"].numpy(),
                            n_communities=o["n_communities"],
                            n_disconnected=o["n_disconnected"], q=o["q"])


@pytest.mark.parametrize("compact_window", [0, 3])
def test_prepare_update_seq_and_deferred_compaction(compact_window):
    g = _ego(4)
    pair = Pair(compact_window=compact_window)
    pair.put("g", g)
    u, v, dw = _edges(g, 5, k=6)
    keep = u != v
    seq = [jd.GraphUpdate(remove=[3]),
           jd.GraphUpdate(u=u[keep] % 20, v=v[keep] % 20, dw=dw[keep],
                          add=2),
           jd.GraphUpdate(u=np.array([0, 1]), v=np.array([5, 6]),
                          dw=np.array([-5.0, 2.0], np.float32),
                          remove=[7])]
    both = [_both(b) for b in seq]
    pj = pair.ref.prepare_update_seq("g", [b[0] for b in both])
    pt = pair.port.prepare_update_seq("g", [b[1] for b in both])
    _plans_equal(pt, pj)
    scan = pt.scan
    _commit_both(pair, (pj, pt), scan)
    pair.check("g")
    # one more removal: with the window at 3 tombstones, the next fold
    # flushes first; then an explicit flush of what is pending
    more = _both(jd.GraphUpdate(remove=[1]))
    plans = (pair.ref.prepare_update("g", more[0]),
             pair.port.prepare_update("g", more[1]))
    _plans_equal(plans[1], plans[0])
    _commit_both(pair, plans, scan)
    pair.check("g")
    last = _both(jd.GraphUpdate(remove=[2]))
    plans = (pair.ref.prepare_update("g", last[0]),
             pair.port.prepare_update("g", last[1]))
    _plans_equal(plans[1], plans[0])
    _commit_both(pair, plans, scan)
    pair.check("g")
    pair.call("flush_compaction", "g")
    pair.check("g")
    if compact_window:
        assert pair.port.n_compaction_flushes >= 1
        assert pair.port.get("g").deferred.size == 0


def test_stale_commit_dropped():
    g = _ego(6)
    pair = Pair()
    pair.put("g", g)
    upd = _both(jd.GraphUpdate(u=np.array([0]), v=np.array([9]),
                               dw=np.ones(1, np.float32)))
    plans = (pair.ref.prepare_update("g", upd[0]),
             pair.port.prepare_update("g", upd[1]))
    pair.put("g", g)                     # re-detected while the plan ran
    for store, plan in ((pair.ref, plans[0]), (pair.port, plans[1])):
        assert store.commit_update(plan, C=plan.C_prev, n_communities=1,
                                   n_disconnected=0, q=0.0) is None
    pair.check("g")
    assert pair.port.n_stale_commits == 1
