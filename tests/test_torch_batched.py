"""The batched engine's tile (the reference's ``jit(lax.map(vmap(...)))``
lane-parallel batch) held, on the CPU, to ``run_detection`` of each graph
alone and to the JAX package's engine at the same ``sub_batch``.

A tile runs the standard tier (``split='sp-pj'``) on the dense scan for
``b`` graphs of one bucket at once (``core/portfolio.py:
run_detection_tile``).  Each graph's labels, stats, ``n_disconnected``,
``fraction`` and Q must be the bits of ``run_detection`` (``detect()``'s
body) on it alone: at widths 1, 2, 3 and 8, with a partial last tile,
graphs of different ``n_nodes``, a graph that ends its pass loop passes
before the others, one that converges sweeps earlier in a pass, a
``unit_graph`` filler, and the six tier-1 families.  The pieces are held
the same way: the batched plain half-sweep, the per-graph
``sum_inorder``, the tile's split, renumber, aggregation, detector and
modularity, and ``local_move_tile``.  ``stack_graphs`` is held to the
reference's.  Small sizes only; the reference engine runs on one bucket.
"""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_tile_cases import tile_state
from test_torch_detect import GRAPHS, Q_ATOL, _port

import repro.service as jservice
from repro.graph import sbm_graph
from repro.service.buckets import admit as j_admit
from repro_torch.core import DetectOptions, LouvainConfig
from repro_torch.core import _segments as seg
from repro_torch.core.aggregate import aggregate, aggregate_union
from repro_torch.core.detect import (disconnected_communities,
                                     disconnected_communities_tile)
from repro_torch.core.local_move import (SYNC_PHASES, _half_sweep_dense_plain,
                                         _move_loop, dense_adjacency,
                                         local_move_tile, realized_modularity,
                                         realized_modularity_tile,
                                         tile_adjacency)
from repro_torch.core.louvain import louvain_impl, louvain_tile
from repro_torch.core.modularity import modularity, modularity_tile
from repro_torch.core.portfolio import (run_detection, run_detection_tile,
                                        tile_route)
from repro_torch.core.split import split_labels, split_labels_tile
from repro_torch.graph.container import (repad, stack_graphs, strip_padding,
                                         union_of, union_ghosts, unit_graph,
                                         vertex_offsets)
from repro_torch.kernels import ops
from repro_torch.service import BatchedLouvainEngine, Bucket

BUCKET = (64, 2048)
STANDARD = DetectOptions(scan="dense")


def _ego_j(seed, n):
    g = sbm_graph(n_nodes=n, n_blocks=3, p_in=0.4, p_out=0.04, seed=seed)[0]
    return j_admit(g, [jservice.Bucket(*BUCKET)])[0]


def _pool_j(k):
    """``k`` reference ego-nets of one bucket, of different ``n_nodes``."""
    return [_ego_j(s, 24 + (7 * s) % 37) for s in range(k)]


def _pool(k, filler_at=None):
    graphs = [_port(g) for g in _pool_j(k)]
    if filler_at is not None:
        graphs.insert(filler_at, unit_graph(*BUCKET, device="cpu"))
    return graphs


def _same(a, b, what=""):
    """Two ``Detection``s: labels, stats, counts, fraction and Q bits."""
    assert torch.equal(a.labels, b.labels), what
    assert a.stats == b.stats, (what, a.stats, b.stats)
    assert (a.n_communities, a.n_disconnected) == (
        b.n_communities, b.n_disconnected), what
    assert a.fraction == b.fraction, what
    assert np.float32(a.modularity).view(np.int32) == \
        np.float32(b.modularity).view(np.int32), what


def _tile_equals_alone(graphs, options=STANDARD):
    tile = run_detection_tile(graphs, options)
    assert len(tile) == len(graphs)
    for i, (g, d) in enumerate(zip(graphs, tile)):
        _same(d, run_detection(g, options), f"graph {i}")
    return tile


# ---------------------------------------------------------------------------
# the container: stack_graphs and the union
# ---------------------------------------------------------------------------

def test_stack_graphs_matches_reference():
    from repro.graph.container import stack_graphs as j_stack

    gj = _pool_j(3)
    st, sj = stack_graphs([_port(g) for g in gj]), j_stack(gj)
    for name in ("src", "dst", "w", "n_nodes"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)))
    assert (st.n_cap, st.m_cap) == (sj.n_cap, sj.m_cap)
    assert st.src.shape == (3, BUCKET[1]) and st.n_nodes.shape == (3,)
    with pytest.raises(ValueError, match="at least one"):
        stack_graphs([])
    with pytest.raises(ValueError, match="homogeneous"):
        stack_graphs([_port(gj[0]), unit_graph(64, 512, device="cpu")])


def test_union_lays_out_each_graphs_live_edges():
    graphs = _pool(3, filler_at=1)
    u = union_of(stack_graphs(graphs))
    nv = graphs[0].nv
    assert (u.b, u.nv) == (4, nv)
    np.testing.assert_array_equal(vertex_offsets(4, nv, "cpu").numpy(),
                                  np.arange(4) * nv)
    np.testing.assert_array_equal(union_ghosts(4, nv, "cpu").numpy(),
                                  np.arange(4) * nv + nv - 1)
    off = u.edge_offsets
    for g, gr in enumerate(graphs):
        live = strip_padding(gr.src, gr.dst, gr.w, gr.ghost)
        assert u.counts[g] == live[0].shape[0]
        sl = slice(off[g], off[g + 1])
        assert torch.equal(u.src[sl], live[0] + g * nv)
        assert torch.equal(u.dst[sl], live[1] + g * nv)
        assert torch.equal(u.w[sl], live[2])
    assert bool(torch.all(u.src[1:] >= u.src[:-1]))


# ---------------------------------------------------------------------------
# the per-graph pieces against their single-graph versions
# ---------------------------------------------------------------------------

LENGTH_SETS = [(1,), (0, 5), (1023, 1024, 1025), (3000, 1, 0, 2049),
               (70_000, 7, 1_100_000)]


@pytest.mark.parametrize("lengths", LENGTH_SETS,
                         ids=["-".join(map(str, x)) for x in LENGTH_SETS])
def test_sum_inorder_per_graph_equals_lone_sums(lengths):
    rng = np.random.default_rng(sum(lengths))
    x = torch.from_numpy((rng.random(sum(lengths)) * 3).astype(np.float32))
    got = ops.sum_inorder_per_graph(x, lengths)
    assert got.shape == (len(lengths),)
    start = 0
    for g, n in enumerate(lengths):
        want = ops.sum_inorder(x[start:start + n])
        assert got[g].view(torch.int32) == want.view(torch.int32), (g, n)
        start += n


@pytest.mark.parametrize("target,anchored", [(True, True), (False, True),
                                             (False, False)])
def test_batched_plain_half_sweep_equals_lone(target, anchored):
    graphs = _pool(4, filler_at=2)
    lone, union, u = tile_state(graphs)
    b, nv = u.b, u.nv
    src, dst, w, C, K, Sigma, two_m, movable, tok = union
    got = _half_sweep_dense_plain(src, dst, w, C, K, Sigma, two_m, movable,
                                  tok if target else None, anchored,
                                  graphs=b)
    assert got[3].shape == (b,)
    for g, a in enumerate(lone):
        want = _half_sweep_dense_plain(*a[:8], a[8] if target else None,
                                       anchored)
        sl = slice(g * nv, (g + 1) * nv)
        assert torch.equal(got[0][sl] - g * nv, want[0]), g
        assert torch.equal(got[1][sl].view(torch.int32),
                           want[1].view(torch.int32)), g
        assert torch.equal(got[2][sl], want[2]) and \
            torch.equal(got[4][sl], want[4]), g
        assert abs(float(got[3][g]) - float(want[3])) <= 1e-6, g


def test_tile_realized_modularity_equals_lone():
    graphs = _pool(3, filler_at=0)
    lone, union, u = tile_state(graphs, seed=3)
    src, dst, w, C, K, Sigma, two_m = union[:7]
    got = realized_modularity_tile(src, dst, w, C, Sigma, two_m, u.counts)
    for g, a in enumerate(lone):
        want = realized_modularity(a[0], a[1], a[2], a[3], a[5], a[6])
        assert got[g].view(torch.int32) == want.view(torch.int32), g


def test_tile_split_renumber_detector_modularity_equal_lone():
    """Each graph's split labels, renumber, detector and modularity on the
    union are its own, at a partition that leaves some communities
    disconnected."""
    graphs = _pool(5, filler_at=3)
    lone, union, u = tile_state(graphs, seed=11)
    b, nv = u.b, u.nv
    C_u = union[3]
    base = torch.arange(b * nv, dtype=torch.int32) // nv * nv
    adj = tile_adjacency(u.src, u.dst, b, nv)
    L_u = split_labels_tile((C_u - base).view(b, nv), adj).view(-1) + base
    n_nodes = torch.stack([g.n_nodes for g in graphs])
    valid = (torch.arange(nv)[None, :] < n_nodes[:, None]).view(-1)
    dense_u, n_u = seg.renumber_tile(L_u, valid, b)
    det_u = disconnected_communities_tile(u.src, u.dst, u.w, C_u, valid, b)
    q_u = modularity_tile(u.src, u.dst, u.w, C_u, u.counts)
    n_disc = 0
    for g, (a, gr) in enumerate(zip(lone, graphs)):
        sl = slice(g * nv, (g + 1) * nv)
        L, _ = split_labels(a[0], a[1], a[2], a[3], impl="dense",
                            adj=dense_adjacency(a[0], a[1], nv))
        assert torch.equal(L_u[sl] - g * nv, L), g
        dense, n = seg.renumber(L, valid[sl], nv)
        assert torch.equal(dense_u[sl] - g * nv, dense) and n == n_u[g], g
        det = disconnected_communities(a[0], a[1], a[2], a[3], gr.n_nodes)
        for k in ("n_disconnected", "n_communities", "fraction"):
            assert det_u[k][g] == det[k], (g, k)
        n_disc += int(det["n_disconnected"])
        q = modularity(a[0], a[1], a[2], a[3])
        assert q_u[g].view(torch.int32) == q.view(torch.int32), g
    assert n_disc > 0


def test_aggregate_union_equals_lone_and_drops_done_graphs():
    graphs = _pool(4, filler_at=1)
    lone, union, u = tile_state(graphs, seed=5)
    b, nv = u.b, u.nv
    valid = torch.ones(b * nv, dtype=torch.bool)
    base = torch.arange(b * nv, dtype=torch.int32) // nv * nv
    for g, gr in enumerate(graphs):
        valid[g * nv + int(gr.n_nodes):(g + 1) * nv] = False
    dense_u, _ = seg.renumber_tile(union[3], valid, b)
    keep = torch.tensor([True, True, False, True, True])
    s, d, w, counts = aggregate_union(u.src, u.dst, u.w, dense_u, nv, keep)
    assert counts[2] == 0
    off = np.concatenate([[0], np.cumsum(counts)])
    for g, a in enumerate(lone):
        if not keep[g]:
            continue
        sl = slice(g * nv, (g + 1) * nv)
        want = strip_padding(*aggregate(a[0], a[1], a[2],
                                        dense_u[sl] - base[sl]), nv - 1)
        piece = slice(off[g], off[g + 1])
        assert torch.equal(s[piece] - g * nv, want[0]), g
        assert torch.equal(d[piece] - g * nv, want[1]), g
        assert torch.equal(w[piece].view(torch.int32),
                           want[2].view(torch.int32)), g


@pytest.mark.parametrize("sync", ["handshake", "parity", "all"])
def test_local_move_tile_equals_lone(sync):
    """Each graph's labels, Sigma, ``l_i`` and sweeps are its lone run's;
    the tile holds graphs that converge sweeps apart."""
    graphs = _pool(6, filler_at=4)
    u = union_of(stack_graphs(graphs))
    b, nv = u.b, u.nv
    two_m = ops.sum_inorder_per_graph(u.w, u.counts)
    ids = torch.arange(b * nv, dtype=torch.int32)
    K = ops.segreduce_sorted(u.w, u.src, b * nv, op="sum")
    tau = np.float32(1e-2)
    C, Sigma, li, sweeps = local_move_tile(
        u.src, u.dst, u.w, ids, K, K, two_m, counts=u.counts, tau=tau,
        sync=sync)
    off = u.edge_offsets
    for g in range(b):
        e = slice(off[g], off[g + 1])
        src, dst, w = u.src[e] - g * nv, u.dst[e] - g * nv, u.w[e]
        Kg = K[g * nv:(g + 1) * nv]
        Cg, Sg, lig, itg = _move_loop(
            src, dst, w, torch.arange(nv, dtype=torch.int32), Kg, Kg,
            ops.sum_inorder(w), tau=tau, max_iters=20,
            phases=SYNC_PHASES[sync], prune=True,
            active0=torch.ones(nv, dtype=torch.bool), warm=False,
            scan="dense", adj=None)
        sl = slice(g * nv, (g + 1) * nv)
        assert torch.equal(C[sl] - g * nv, Cg), g
        assert torch.equal(Sigma[sl].view(torch.int32),
                           Sg.view(torch.int32)), g
        assert (li[g], sweeps[g]) == (lig, itg), g
    assert len(set(sweeps.tolist())) > 1, sweeps


# ---------------------------------------------------------------------------
# the tile's pass loop and run_detection_tile against the lone runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 2, 3, 8])
def test_tile_equals_detect_at_width(b):
    _tile_equals_alone(_pool(b))


def test_tile_with_a_filler_and_graphs_leaving_passes_apart():
    """A ``unit_graph`` ends its pass loop after one pass, the ego-nets
    after two or three: each leaves the union when its loop is done."""
    graphs = _pool(5, filler_at=2)
    tile = _tile_equals_alone(graphs)
    passes = [d.stats["passes"] for d in tile]
    assert passes[2] == 1 and max(passes) > 1, passes
    C, stats, u = louvain_tile(stack_graphs(graphs))
    for g, gr in enumerate(graphs):
        Cg, st = louvain_impl(gr, LouvainConfig(), scan="dense")
        assert torch.equal(C[g], Cg) and stats[g] == st, g
    assert u.counts == tuple(
        int((gr.src < gr.ghost).sum()) for gr in graphs)


FAMILY_RUNS = [(sync, prune) for sync in ("handshake", "parity", "all")
               for prune in (True, False)]


@pytest.mark.parametrize("sync,prune", FAMILY_RUNS,
                         ids=[f"{s}-{p}" for s, p in FAMILY_RUNS])
def test_tile_of_the_six_families(sync, prune):
    """The six tier-1 families re-padded into one bucket (different
    ``n_nodes`` and edge counts), one tile, every sync and prune
    setting."""
    fams = [_port(f()) for f in GRAPHS.values()]
    n_cap = max(g.n_cap for g in fams)
    m_cap = max(g.num_edges() for g in fams)
    graphs = [repad(g, n_cap, m_cap) for g in fams]
    _tile_equals_alone(graphs, DetectOptions(
        scan="dense", louvain=LouvainConfig(sync=sync, prune=prune)))


def test_tile_refuses_what_it_does_not_run():
    """The tile runs every tier and split on either scan; any mesh stays
    off it."""
    graphs = _pool(2)
    for opts in (DetectOptions(scan="sort", mesh=2),
                 DetectOptions(scan="sort", algorithm="max-quality", mesh=2),
                 DetectOptions(scan="dense", mesh=2),
                 DetectOptions(scan="sort", algorithm="fast", mesh=2)):
        assert not tile_route(opts)
        with pytest.raises(ValueError, match="the tile runs"):
            run_detection_tile(graphs, opts)
    for opts in (STANDARD, DetectOptions(scan="dense", algorithm="fast"),
                 DetectOptions(scan="sort", algorithm="fast"),
                 DetectOptions(scan="dense", algorithm="max-quality"),
                 DetectOptions(scan="dense",
                               louvain=LouvainConfig(split="refine")),
                 DetectOptions(scan="sort"),
                 DetectOptions(scan="sort", algorithm="max-quality"),
                 DetectOptions(scan="sort",
                               louvain=LouvainConfig(split="sl-lpp"))):
        assert tile_route(opts), opts
    C, stats, _ = louvain_tile(stack_graphs(graphs),
                               LouvainConfig(split="sp-lp"))
    assert [s["passes"] for s in stats] == [
        louvain_impl(g, LouvainConfig(split="sp-lp"), scan="dense")[1][
            "passes"] for g in graphs]


# ---------------------------------------------------------------------------
# the engine: tiles, routes, keys, warm-up, and the reference's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sub_batch", [2, 3, 8])
def test_engine_tiles_equal_detect(sub_batch):
    """Ten graphs in tiles of ``sub_batch`` (a partial last tile; at 3 a
    last tile of one graph): every result is ``detect()``'s."""
    graphs = _pool(9, filler_at=4)
    eng = BatchedLouvainEngine(device="cpu", sub_batch=sub_batch)
    res = eng.detect_batch(graphs)
    info = eng.last_detect_info
    assert (info.route, info.n) == ("tile", 10)
    assert info.capacity == -(-10 // sub_batch) * sub_batch
    assert info.fill == 10 / info.capacity
    for g, r in zip(graphs, res):
        d = run_detection(g, DetectOptions())
        np.testing.assert_array_equal(r.C, d.labels.numpy())
        assert (r.n_communities, r.n_disconnected, r.passes, r.sweeps,
                r.split_moved) == (d.n_communities, d.n_disconnected,
                                   d.stats["passes"], d.stats["li_total"],
                                   d.stats["split_moved"])
        assert r.fraction == d.fraction and r.q == d.modularity


@pytest.mark.parametrize("sub_batch", [2, 3, 8])
def test_engine_equals_reference_engine_at_its_width(sub_batch):
    gj = _pool_j(5)
    want = jservice.BatchedLouvainEngine(sub_batch=sub_batch).detect_batch(gj)
    eng = BatchedLouvainEngine(device="cpu", sub_batch=sub_batch)
    got = eng.detect_batch([_port(g) for g in gj])
    assert eng.last_detect_info.route == "tile"
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.C, np.asarray(b.C))
        for f in ("n_communities", "passes", "sweeps", "split_moved",
                  "n_disconnected", "fraction"):
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.q - b.q) <= Q_ATOL


def test_engine_routes_and_keys():
    b = Bucket(*BUCKET)
    eng = BatchedLouvainEngine(device="cpu", sub_batch=4,
                               algorithms=("standard", "fast"))
    assert BatchedLouvainEngine(device="cpu").sub_batch == 1
    assert eng.route_for(b) == "tile"
    assert eng.route_for(b, "fast") == "tile"
    assert eng.route_for(b, "max-quality") == "tile"
    assert eng.scan_for(Bucket(256, 1024)) == "sort"
    assert eng.route_for(Bucket(256, 1024)) == "tile"        # the sortscan
    assert eng.route_for(Bucket(256, 1024), "max-quality") == "tile"
    assert eng.route_for(Bucket(256, 1024), "fast") == "tile"
    assert BatchedLouvainEngine(device="cpu", sub_batch=1).route_for(b) \
        == "loop"
    assert eng._detect_key(b)[:2] == (b, 4)
    assert eng.warm(b) == 2
    info = eng.last_detect_info
    assert (info.n, info.capacity, info.route) == (4, 4, "tile")
    graphs = _pool(3)
    eng.detect_batch(graphs)
    info = eng.last_detect_info
    assert info.compile_hit and info.route == "tile" and info.fill == 0.75
    eng.detect_batch(graphs, algorithm="fast")
    assert eng.last_detect_info.route == "tile"
    nv = graphs[0].nv
    eng.update_batch([(graphs[0], np.arange(nv, dtype=np.int32),
                       np.zeros(nv, bool))])
    assert (eng.last_update_info.route, eng.last_update_info.capacity) == (
        "tile", 4)                                          # the dense scan
    g_sort = _port(j_admit(sbm_graph(n_nodes=96, n_blocks=3, p_in=0.08,
                                     p_out=0.01, seed=5)[0],
                           [jservice.Bucket(256, 1024)])[0])
    eng.update_batch([(g_sort, np.arange(g_sort.nv, dtype=np.int32),
                       np.zeros(g_sort.nv, bool))])
    assert (eng.last_update_info.route, eng.last_update_info.capacity) == (
        "tile", 4)                                          # the sortscan
