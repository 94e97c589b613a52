"""Fully-dynamic updates of the PyTorch port (``repro_torch.core.dynamic``)
held against the JAX package's ``repro.core.dynamic``, on the CPU.

The host folds (edge deltas, vertex removal and addition, tombstones,
validation) must give the reference's arrays, labels, masks, ``info`` and
errors exactly; every rewritten graph keeps ``src`` sorted, which the
in-order K by ``src`` relies on.  The device part (screening, the warm
local move, ``update_communities`` with either scan) must give the
reference's rewritten graph, labels and every integer stat bit for bit:
on these graphs the decision sums (2m, the realized Q of every sweep)
stay below 2**24.  The final ``q`` is the port's ``modularity``, whose
last flat sum folds in another order than the reference's ``jnp.sum``
(ROADMAP C.6); it is held to the port's own ``modularity`` bit for bit and
to the reference within ``Q_ATOL``, and the one case found where the two
orders part (ROADMAP C.8) is pinned below.
Mirrors the non-service cases of tests/test_dynamic_deletions.py,
tests/test_dynamic_vertices.py and tests/test_lpa_dynamic.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import Q_ATOL, _port, _t

import repro.core as jcore
import repro.graph as rg
from repro.core import dynamic as jd
from repro.core.modularity import modularity as j_modularity
from repro_torch.core import dynamic as td
from repro_torch.core.modularity import modularity as t_modularity
from repro_torch.graph import remap_vertices as t_remap_vertices
from repro_torch.graph.container import strip_padding

CFG = jcore.LouvainConfig()
SCANS = ["sort", "dense"]


def _same_graph(gt, gj, what=""):
    """The port's graph equals the reference's, and keeps src sorted."""
    for name in ("src", "dst", "w"):
        np.testing.assert_array_equal(
            getattr(gt, name).numpy(), np.asarray(getattr(gj, name)),
            err_msg=f"{what} {name}")
    assert int(gt.n_nodes) == int(gj.n_nodes), what
    assert (gt.n_cap, gt.m_cap) == (gj.n_cap, gj.m_cap), what
    src = gt.src.numpy()
    assert np.all(src[1:] >= src[:-1]), f"{what}: src not sorted"


def _same_info(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def _planted_ring():
    """ring_of_cliques(30, 4) with edge slack; cold louvain merges cliques
    (resolution limit), leaving intra-community ring bridges."""
    k, c = 30, 4
    m_nat = 2 * k * (c * (c - 1) // 2 + 1)
    g = rg.ring_of_cliques(k, c, m_cap=m_nat + 64)
    C = np.asarray(jcore.louvain(g, CFG)[0])
    bridges = [(ci * c, ((ci + 1) % k) * c) for ci in range(k)]
    intra = [(u, v) for u, v in bridges if C[u] == C[v]]
    assert intra
    return g, C, intra


def _both_updates(gj, C, upd_j, upd_t, scan):
    """One update in each package; the port from its own copy of ``gj``."""
    gj2, Cj, sj = jd.update_communities(gj, jnp.asarray(C), upd_j, scan=scan)
    gt2, Ct, st = td.update_communities(_port(gj), _t(C), upd_t, scan=scan,
                                        device="cpu")
    _same_graph(gt2, gj2, f"update ({scan})")
    np.testing.assert_array_equal(Ct.numpy(), np.asarray(Cj))
    assert {k: v for k, v in st.items() if k != "q"} == {
        k: int(v) for k, v in sj.items() if k != "q"}
    live = strip_padding(gt2.src, gt2.dst, gt2.w, gt2.ghost)
    assert st["q"] == float(t_modularity(*live, Ct))
    assert abs(st["q"] - float(sj["q"])) <= Q_ATOL
    return gj2, np.asarray(Cj), st


# ---------------------------------------------------------------------------
# host folds
# ---------------------------------------------------------------------------

def test_merge_edge_deltas_nets_within_batch():
    gj, _ = rg.sbm_graph(n_nodes=30, n_blocks=3, seed=0)
    tg = _port(gj)
    n_live = int((np.asarray(gj.src) < gj.n_cap).sum())
    batch = td.directed_deltas(np.array([1, 1, 2]), np.array([17, 17, 2]),
                               np.array([2.0, -2.0, 0.5], np.float32))
    want = jd.directed_deltas(np.array([1, 1, 2]), np.array([17, 17, 2]),
                              np.array([2.0, -2.0, 0.5], np.float32))
    for a, b in zip(batch, want):
        np.testing.assert_array_equal(a, b)
    got = td.merge_edge_deltas(tg, *batch)
    ref = jd.merge_edge_deltas(gj, *want)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) == n_live + 1     # the self-loop; 1-17 netted to 0


def test_weight_delta_rewrites_in_place_and_deletes():
    gj, _ = rg.sbm_graph(n_nodes=30, n_blocks=3, seed=0)
    tg = _port(gj)
    src, dst, w = (np.asarray(gj.src), np.asarray(gj.dst), np.asarray(gj.w))
    live = (src < gj.n_cap) & (src < dst)
    u, v, wv = src[live][0], dst[live][0], w[live][0]
    for dw in (-wv / 2, -wv):
        d = td.directed_deltas(np.array([u]), np.array([v]),
                               np.array([dw], np.float32))
        g2 = td.apply_edge_updates(tg, *d)
        _same_graph(g2, jd.apply_edge_updates(gj, *d), f"delta {dw}")
        assert g2.device == tg.device
    assert int((g2.src < g2.n_cap).sum()) == int((src < gj.n_cap).sum()) - 2


def test_delete_missing_edge_is_noop():
    gj, _ = rg.sbm_graph(n_nodes=30, n_blocks=3, seed=0)
    src, dst = np.asarray(gj.src), np.asarray(gj.dst)
    have = set(zip(src[src < gj.n_cap].tolist(), dst[src < gj.n_cap].tolist()))
    u, v = next((a, b) for a in range(30) for b in range(a + 1, 30)
                if (a, b) not in have)
    d = td.directed_deltas(np.array([u]), np.array([v]),
                           np.array([-5.0], np.float32))
    g2 = td.apply_edge_updates(_port(gj), *d)
    _same_graph(g2, gj, "missing edge")


def test_capacity_reuse_and_capacity_error():
    gj, _ = rg.sbm_graph(n_nodes=60, n_blocks=3, seed=3)   # m_cap == m
    tg = _port(gj)
    src, dst, w = (np.asarray(gj.src), np.asarray(gj.dst), np.asarray(gj.w))
    live = (src < gj.n_cap) & (src < dst)
    have = set(zip(src[src < gj.n_cap].tolist(), dst[src < gj.n_cap].tolist()))
    nu, nv_ = next((a, b) for a in range(60) for b in range(a + 1, 60)
                   if (a, b) not in have)
    add = td.directed_deltas(np.array([nu]), np.array([nv_]),
                             np.array([1.0], np.float32))
    with pytest.raises(td.CapacityError, match="edge capacity") as got:
        td.apply_edge_updates(tg, *add)
    with pytest.raises(jd.CapacityError) as want:
        jd.apply_edge_updates(gj, *add)
    assert str(got.value) == str(want.value)
    assert issubclass(td.CapacityError, ValueError)
    # delete one pair first: its two freed slots admit the new pair
    d = td.directed_deltas(np.array([src[live][0], nu]),
                           np.array([dst[live][0], nv_]),
                           np.array([-w[live][0], 1.0], np.float32))
    _same_graph(td.apply_edge_updates(tg, *d), jd.apply_edge_updates(gj, *d),
                "reuse")
    with pytest.raises(td.CapacityError):
        td.update_communities(tg, torch.arange(tg.nv, dtype=torch.int32),
                              (np.array([nu]), np.array([nv_]),
                               np.array([1.0], np.float32)), device="cpu")


def test_add_then_delete_round_trip():
    rng = np.random.default_rng(3)
    gj, _ = rg.sbm_graph(n_nodes=40, n_blocks=3, seed=1, m_cap=1024)
    tg = _port(gj)
    src, dst = np.asarray(gj.src), np.asarray(gj.dst)
    have = set(zip(src[src < gj.n_cap].tolist(), dst[src < gj.n_cap].tolist()))
    non_edges = [(a, b) for a in range(40) for b in range(a, 40)
                 if (a, b) not in have]
    idx = rng.choice(len(non_edges), 6, replace=False)
    u = np.array([non_edges[i][0] for i in idx])
    v = np.array([non_edges[i][1] for i in idx])
    w = rng.uniform(0.25, 4.0, 6).astype(np.float32)
    g1 = td.apply_edge_updates(tg, *td.directed_deltas(u, v, w))
    _same_graph(g1, jd.apply_edge_updates(gj, *jd.directed_deltas(u, v, w)),
                "added")
    g2 = td.apply_edge_updates(g1, *td.directed_deltas(u, v, -w))
    _same_graph(g2, gj, "round trip")
    assert td.gross_deleted(g1, g2) == jd.gross_deleted(
        jd.apply_edge_updates(gj, *jd.directed_deltas(u, v, w)), gj) > 0


def test_gross_deleted_counts_unique_pairs_alike():
    """The gross deletion count on random edge sets with parallel entries
    (the reference's ``setdiff1d`` of ``np.unique`` keys)."""
    rng = np.random.default_rng(4)
    for _ in range(30):
        graphs = []
        for m in rng.integers(0, 60, 2):
            src = np.sort(rng.integers(0, 12, m)).astype(np.int32)
            dst = rng.integers(0, 12, m).astype(np.int32)
            pad = np.full(5, 12, np.int32)
            graphs.append(td.HostGraph(
                np.concatenate([src, pad]), np.concatenate([dst, pad]),
                np.ones(m + 5, np.float32), 12, 12, int(m) + 5))
        assert td.gross_deleted(*graphs) == jd.gross_deleted(*graphs)


def test_removal_compacts_ids_order_preserving():
    gj, _ = rg.sbm_graph(n_nodes=20, n_blocks=2, seed=3, m_cap=512)
    C = np.asarray(jcore.louvain(gj, CFG)[0])
    rem = np.array([4, 11])
    touched = np.zeros(gj.nv, bool)
    touched[[2, 15]] = True
    want = jd.apply_vertex_updates(gj, C, remove=rem, touched=touched)
    got = td.apply_vertex_updates(_port(gj), _t(C), remove=rem,
                                  touched=touched)
    _same_graph(got[0], want[0], "compacted")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    _same_info(got[3], want[3])
    perm = got[3]["perm"]
    for old in range(20):
        assert perm[old] == (-1 if old in (4, 11)
                             else old - (old > 4) - (old > 11))
    _same_graph(t_remap_vertices(_port(gj), perm, 18),
                rg.remap_vertices(gj, perm, 18), "remap_vertices")
    with pytest.raises(ValueError, match="perm must have shape"):
        t_remap_vertices(_port(gj), perm[:-1], 18)


def test_additions_and_labels_without_membership():
    gj, _ = rg.sbm_graph(n_nodes=40, n_blocks=3, seed=1, m_cap=1024, n_cap=48)
    want = jd.apply_vertex_updates(gj, None, add=3, remove=np.array([0, 39]))
    got = td.apply_vertex_updates(_port(gj), None, add=3,
                                  remove=np.array([0, 39]))
    _same_graph(got[0], want[0], "add and remove")
    assert got[1] is None and want[1] is None
    np.testing.assert_array_equal(got[2], want[2])
    _same_info(got[3], want[3])
    got = td.apply_vertex_updates(_port(gj), None, add=2)   # pure addition
    _same_graph(got[0], jd.apply_vertex_updates(gj, None, add=2)[0], "add")


def test_cut_vertex_removal_fold():
    gj, C, intra = _planted_ring()
    u, _ = intra[0]
    want = jd.apply_vertex_updates(gj, C, remove=np.array([u]))
    got = td.apply_vertex_updates(_port(gj), C, remove=np.array([u]))
    _same_graph(got[0], want[0], "cut vertex")
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a, b)
    _same_info(got[3], want[3])
    # (b): the removed vertex's whole former community is touched
    assert got[2][:int(gj.n_nodes) - 1].sum() >= (C == C[u]).sum() - 1


@pytest.mark.parametrize("with_labels", [True, False])
def test_tombstone_vertices_equal(with_labels):
    gj, C, intra = _planted_ring()
    rem = np.array([intra[0][0], 7, 50])
    C_in = C if with_labels else None
    touched = np.zeros(gj.nv, bool)
    touched[3] = True
    want = jd.tombstone_vertices(gj, C_in, rem, touched=touched)
    got = td.tombstone_vertices(_port(gj), None if C_in is None else _t(C),
                                rem, touched=touched)
    _same_graph(got[0], want[0], "tombstones")
    if with_labels:
        np.testing.assert_array_equal(got[1], want[1])
    else:
        assert got[1] is None
    np.testing.assert_array_equal(got[2], want[2])
    _same_info(got[3], want[3])
    empty = td.tombstone_vertices(_port(gj), C_in, np.array([], np.int64))
    assert empty[3]["n_removed"] == 0
    with pytest.raises(ValueError, match="duplicate"):
        td.tombstone_vertices(_port(gj), C_in, np.array([3, 3]))


def test_combined_batch_edge_ids_follow_rewrite():
    gj, _ = rg.sbm_graph(n_nodes=30, n_blocks=3, seed=0, n_cap=40, m_cap=512)
    C = np.asarray(jcore.louvain(gj, CFG)[0])
    upd = dict(u=np.array([29, 29]), v=np.array([3, 4]),
               dw=np.ones(2, np.float32), add=1, remove=np.array([0]))
    want = jd.prepare_graph_update(gj, C, jcore.GraphUpdate(**upd))
    got = td.prepare_graph_update(_port(gj), C, td.GraphUpdate(**upd))
    _same_graph(got[0], want[0], "combined")
    for a, b in zip(got[1:3], want[1:3]):
        np.testing.assert_array_equal(a, b)
    _same_info(got[3], want[3])
    bad = dict(u=np.array([30]), v=np.array([0]), dw=np.ones(1, np.float32),
               add=1, remove=np.array([0]))
    with pytest.raises(ValueError, match="endpoint ids") as err_t:
        td.prepare_graph_update(got[0], got[1], td.GraphUpdate(**bad))
    with pytest.raises(ValueError, match="endpoint ids") as err_j:
        jd.prepare_graph_update(want[0], want[1], jcore.GraphUpdate(**bad))
    assert str(err_t.value) == str(err_j.value)


def test_vertex_capacity_error_and_rebuild():
    gj, _ = rg.sbm_graph(n_nodes=30, n_blocks=3, seed=0, n_cap=31)
    tg = _port(gj)
    with pytest.raises(td.CapacityError, match="vertex capacity"):
        td.apply_vertex_updates(tg, None, add=2)
    g2, _, _, _ = td.apply_vertex_updates(tg, None, add=2,
                                          remove=np.array([5]))
    assert int(g2.n_nodes) == 31
    g3 = td.rebuild_with_vertex_ops(tg, add=4, remove=np.array([2]))
    _same_graph(g3, jd.rebuild_with_vertex_ops(gj, add=4,
                                               remove=np.array([2])),
                "rebuild")
    assert int(g3.n_nodes) == 33 and g3.n_cap >= 33


def _raises_alike(fn_t, fn_j):
    with pytest.raises(ValueError) as got:
        fn_t()
    with pytest.raises(ValueError) as want:
        fn_j()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_as_update_and_check_vertex_ids_validation():
    cases = [
        lambda m: m.as_update((np.array([1]), np.array([1, 2]), np.ones(1))),
        lambda m: m.as_update((np.array([1.5]), np.array([2.5]), np.ones(1))),
        lambda m: m.as_update(m.GraphUpdate(add=-1)),
        lambda m: m.as_update(m.GraphUpdate(remove=np.array([3, 3]))),
        lambda m: m.as_update(m.GraphUpdate(remove=np.array([-1]))),
        lambda m: m.as_update(m.GraphUpdate(remove=np.array([0.5]))),
        lambda m: m.check_vertex_ids(np.array([0]), np.array([1]), 1),
        lambda m: m.check_vertex_ids(np.array([-1]), np.array([0]), 4),
    ]
    for case in cases:
        _raises_alike(lambda: case(td), lambda: case(jd))
    upd = td.as_update((np.array([0]), np.array([1]), [2.0]))
    assert isinstance(upd, td.GraphUpdate) and not upd.has_vertex_ops
    assert upd.has_edges and upd.dw.dtype == np.float32
    td.check_vertex_ids(upd.u, upd.v, 2)
    np.testing.assert_array_equal(td.touched_mask(5, [0, 3], [3, 4]),
                                  jd.touched_mask(5, [0, 3], [3, 4]))


def test_vertex_range_errors_alike():
    gj, _ = rg.sbm_graph(n_nodes=30, n_blocks=3, seed=0, n_cap=40)
    tg = _port(gj)
    _raises_alike(
        lambda: td.apply_vertex_updates(tg, None, remove=np.array([30])),
        lambda: jd.apply_vertex_updates(gj, None, remove=np.array([30])))
    _raises_alike(
        lambda: td.prepare_graph_update(
            tg, None, td.GraphUpdate(remove=np.array([35]))),
        lambda: jd.prepare_graph_update(
            gj, None, jcore.GraphUpdate(remove=np.array([35]))))
    _raises_alike(
        lambda: td.apply_vertex_updates(tg, None, add=-1),
        lambda: jd.apply_vertex_updates(gj, None, add=-1))


# ---------------------------------------------------------------------------
# the device part
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["edges", "removal", "index-list"])
def test_affected_mask_equal(case):
    gj, _ = rg.sbm_graph(n_nodes=300, n_blocks=6, p_in=0.3, p_out=0.005,
                         seed=1)
    C = np.asarray(jcore.louvain(gj, CFG)[0])
    if case == "removal":
        # labels and mask after a vertex rewrite (dead slots, ghost label)
        gj, C, t, _ = jd.apply_vertex_updates(gj, C,
                                              remove=np.array([3, 77, 150]))
    else:
        t = jd.touched_mask(gj.nv, [0, 1], [200, 1])
    tg = _port(gj)
    if case == "index-list":
        want = jd.affected_vertices(gj, jnp.asarray(C),
                                    jnp.asarray([0, 1, 200], jnp.int32))
        got = td.affected_vertices(tg, _t(C), np.array([0, 1, 200]))
    else:
        want = jd.affected_mask(gj, jnp.asarray(C), jnp.asarray(t))
        got = td.affected_mask(tg, _t(C), _t(t))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(gj.n_nodes)      # screening localizes


@pytest.mark.parametrize("scan", SCANS)
def test_warm_local_move_equal(scan):
    gj, _ = rg.sbm_graph(n_nodes=240, n_blocks=6, p_in=0.35, p_out=0.01,
                         seed=2, m_cap=2 * 9000)
    C = np.asarray(jcore.louvain(gj, CFG)[0])
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, 240, 30), rng.integers(0, 240, 30)
    g2 = jd.apply_edge_updates(gj, *jd.directed_deltas(
        u, v, np.ones(30, np.float32)))
    t = jd.touched_mask(g2.nv, u, v)
    active0 = jd.affected_mask(g2, jnp.asarray(C), jnp.asarray(t))
    two_m = jnp.sum(jnp.asarray(g2.w))
    Cj, Sj, itj = jd.warm_local_move(
        jnp.asarray(g2.src), jnp.asarray(g2.dst), jnp.asarray(g2.w),
        jnp.asarray(C), two_m, active0, scan=scan)
    tg = _port(g2)
    Ct, St, itt = td.warm_local_move(tg.src, tg.dst, tg.w, _t(C),
                                     tg.total_weight_2m(),
                                     _t(np.asarray(active0)), scan=scan)
    np.testing.assert_array_equal(Ct.numpy(), np.asarray(Cj))
    np.testing.assert_array_equal(St.numpy(), np.asarray(Sj))
    assert itt == int(itj)


@pytest.mark.parametrize("scan", SCANS)
def test_planted_bridge_deletion_splits_community(scan):
    gj, C, intra = _planted_ring()
    u, v = intra[0]
    n0 = len(set(C[:int(gj.n_nodes)].tolist()))
    upd = (np.array([u]), np.array([v]), np.array([-1.0], np.float32))
    g2, C2, st = _both_updates(gj, C, upd, upd, scan)
    assert st["n_disconnected"] == 0
    assert st["n_communities"] > n0
    src, dst = np.asarray(g2.src), np.asarray(g2.dst)
    assert not (((src == u) & (dst == v)) | ((src == v) & (dst == u))).any()


@pytest.mark.parametrize("scan", SCANS)
def test_planted_cut_vertex_removal_splits_community(scan):
    gj, C, intra = _planted_ring()
    u, _ = intra[0]
    n0 = len(set(C[:int(gj.n_nodes)].tolist()))
    _, _, st = _both_updates(gj, C, jcore.GraphUpdate(remove=np.array([u])),
                             td.GraphUpdate(remove=np.array([u])), scan)
    assert st["n_disconnected"] == 0 and st["n_removed"] == 1
    assert st["n_communities"] > n0


@pytest.mark.parametrize("scan", SCANS)
def test_delete_every_intra_bridge_sequentially(scan):
    gj, C, intra = _planted_ring()
    for u, v in intra:
        upd = (np.array([u]), np.array([v]), np.array([-1.0], np.float32))
        gj, C, st = _both_updates(gj, C, upd, upd, scan)
        assert st["n_disconnected"] == 0, (u, v)


def _churn(gj, rng, *, remove, add, delete, insert):
    """A seeded batch with every kind of operation: removals, additions
    wired to survivors, deletions of surviving edges, insertions."""
    n = int(gj.n_nodes)
    src, dst, w = (np.asarray(gj.src), np.asarray(gj.dst), np.asarray(gj.w))
    rem = np.sort(rng.choice(n, remove, replace=False))
    perm = jd._survivor_perm(n, rem, gj.nv)
    n2 = n - remove + add
    ok = (src < gj.n_cap) & (src < dst) & (perm[src] >= 0) & (perm[dst] >= 0)
    idx = rng.choice(np.flatnonzero(ok), delete, replace=False)
    new = np.arange(n2 - add, n2)
    u = np.concatenate([perm[src[idx]], np.repeat(new, 2),
                        rng.integers(0, n2, insert)])
    v = np.concatenate([perm[dst[idx]], rng.integers(0, n2 - add, 2 * add),
                        rng.integers(0, n2, insert)])
    dw = np.concatenate([-w[idx], np.ones(2 * add + insert)])
    return dict(u=u, v=v, dw=dw.astype(np.float32), add=add, remove=rem)


@pytest.mark.parametrize("scan", SCANS)
def test_sbm_churn_sequence(scan):
    gj, _ = rg.sbm_graph(n_nodes=120, n_blocks=4, p_in=0.3, p_out=0.02,
                         seed=5, n_cap=140, m_cap=4000)
    C = np.asarray(jcore.louvain(gj, CFG)[0])
    rng = np.random.default_rng(7)
    for step in range(4):
        upd = _churn(gj, rng, remove=3, add=2, delete=5, insert=6)
        gj, C, st = _both_updates(gj, C, jcore.GraphUpdate(**upd),
                                  td.GraphUpdate(**upd), scan)
        assert st["n_disconnected"] == 0, step
        assert st["n_removed"] == 3 and st["n_added"] == 2


def test_final_q_equals_the_reference_modularity_not_its_fused_sum():
    """ROADMAP C.8: at step 2 of the churn sequence above, the port gives
    the reference's graph, labels and every integer stat, and a ``q`` one
    ulp from the ``q`` of the reference's ``update_communities``.  The
    reference disagrees with itself there: its ``modularity`` of the same
    labels gives the port's bits.  Its last flat sum, ``jnp.sum``, folds in
    an order that depends on what XLA fuses around it."""
    gj, _ = rg.sbm_graph(n_nodes=120, n_blocks=4, p_in=0.3, p_out=0.02,
                         seed=5, n_cap=140, m_cap=4000)
    C = np.asarray(jcore.louvain(gj, CFG)[0])
    rng = np.random.default_rng(7)
    for _ in range(2):
        upd = _churn(gj, rng, remove=3, add=2, delete=5, insert=6)
        gj, C, _ = _both_updates(gj, C, jcore.GraphUpdate(**upd),
                                 td.GraphUpdate(**upd), "sort")
    upd = _churn(gj, rng, remove=3, add=2, delete=5, insert=6)
    g2, C2, st = _both_updates(gj, C, jcore.GraphUpdate(**upd),
                               td.GraphUpdate(**upd), "sort")
    q_fused = float(jd.update_communities(gj, jnp.asarray(C),
                                          jcore.GraphUpdate(**upd))[2]["q"])
    q_alone = float(j_modularity(g2.src, g2.dst, g2.w, jnp.asarray(C2)))
    assert st["q"] == q_alone != q_fused
    assert abs(q_alone - q_fused) <= 2 ** -24


@pytest.mark.parametrize("scan", SCANS)
def test_incremental_update_quality_and_connectivity(scan):
    rng = np.random.default_rng(0)
    gj, _ = rg.sbm_graph(n_nodes=240, n_blocks=6, p_in=0.35, p_out=0.01,
                         seed=2, m_cap=2 * 9000)
    C = np.asarray(jcore.louvain(gj, CFG)[0])
    upd = (rng.integers(0, 240, 30), rng.integers(0, 240, 30),
           np.ones(30, np.float32))
    _, _, st = _both_updates(gj, C, upd, upd, scan)
    assert st["n_disconnected"] == 0
    assert st["n_affected"] <= 240


def test_vertex_round_trip_restores_graph():
    gj, _ = rg.sbm_graph(n_nodes=40, n_blocks=3, seed=1, m_cap=1024, n_cap=48)
    C = np.asarray(jcore.louvain(gj, CFG)[0])
    peers = [i for i in range(40) if C[i] == C[0]][:3]
    grow = dict(u=np.array([40] * 3 + [41] * 3), v=np.array(peers * 2),
                dw=np.ones(6, np.float32), add=2)
    g1, C1, st = _both_updates(gj, C, jcore.GraphUpdate(**grow),
                               td.GraphUpdate(**grow), "sort")
    assert st["n_added"] == 2 and C1[40] == C1[41] == C1[peers[0]]
    g2, _, st = _both_updates(g1, C1,
                              jcore.GraphUpdate(remove=np.array([40, 41])),
                              td.GraphUpdate(remove=np.array([40, 41])),
                              "dense")
    for name in ("src", "dst", "w"):
        np.testing.assert_array_equal(np.asarray(getattr(g2, name)),
                                      np.asarray(getattr(gj, name)))
    assert st["n_disconnected"] == 0


def test_unwired_addition_is_singleton():
    gj, _ = rg.sbm_graph(n_nodes=30, n_blocks=3, seed=0, n_cap=40)
    C = np.asarray(jcore.louvain(gj, CFG)[0])
    n0 = len(set(C[:30].tolist()))
    _, _, st = _both_updates(gj, C, jcore.GraphUpdate(add=1),
                             td.GraphUpdate(add=1), "dense")
    assert st["n_communities"] == n0 + 1 and st["n_disconnected"] == 0


def test_update_raises_without_cuda(monkeypatch):
    gj, C, _ = _planted_ring()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.update_communities(_port(gj), _t(C), td.GraphUpdate(add=0))
