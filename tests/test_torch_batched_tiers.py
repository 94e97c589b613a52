"""The batched engine's tile for every tier, held on the CPU to
``run_detection`` of each graph alone and to the JAX package's engine.

PR 29's tile ran the standard tier with ``split='sp-pj'``; here a tile of
``b`` graphs runs the max-quality tier (two pass loops on one union, the
refinement on the union in the split slot, a per-graph pick), the
standard tier with every split policy on the dense scan, and the fast
tier (LPA rounds in lockstep) at every bucket.  Each graph's labels,
stats, ``n_communities``, ``n_disconnected``, ``fraction`` and Q must be
the bits of ``run_detection`` on it alone.  The pieces are held the same
way: ``refine_labels_tile``, ``_split_unconnected_tile`` (the dense split
against the single graph's coo one), ``louvain_tile`` for each split
policy and ``lpa_run_tile``.  The reference engine runs two tiers at one
width, on a pool where its refinement leaves every community connected
(ROADMAP C.7).  Small sizes only.
"""
import importlib

import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_tile_cases import tile_state
from test_torch_batched import _pool, _pool_j, _same
from test_torch_detect import GRAPHS, Q_ATOL, _port

import repro.graph as rg
import repro.service as jservice
from repro_torch.core import DetectOptions, LouvainConfig
from repro_torch.core.local_move import (_half_sweep_dense_plain,
                                         dense_adjacency, tile_adjacency)
from repro_torch.core.louvain import (SPLITS, _split_unconnected,
                                      _split_unconnected_tile, louvain_impl,
                                      louvain_tile, refine_labels,
                                      refine_labels_tile)
from repro_torch.core.lpa import TABLE_CELLS, lpa_run, lpa_run_tile
from repro_torch.core.portfolio import run_detection, run_detection_tile
from repro_torch.graph import from_undirected
from repro_torch.graph.container import repad, stack_graphs
from repro_torch.service import BatchedLouvainEngine

TIERS = ("fast", "max-quality")
# the module (``repro_torch.core.louvain`` is also the function's name)
tlouvain = importlib.import_module("repro_torch.core.louvain")


def _options(algorithm="standard", split="sp-pj"):
    return DetectOptions(scan="dense", algorithm=algorithm,
                         louvain=LouvainConfig(split=split))


def _tile_equals_alone(graphs, options):
    tile = run_detection_tile(graphs, options)
    assert len(tile) == len(graphs)
    for i, (g, d) in enumerate(zip(graphs, tile)):
        _same(d, run_detection(g, options), f"graph {i}")
    return tile


def _families():
    """The six tier-1 families re-padded into one bucket."""
    fams = [_port(f()) for f in GRAPHS.values()]
    n_cap = max(g.n_cap for g in fams)
    m_cap = max(g.num_edges() for g in fams)
    return [repad(g, n_cap, m_cap) for g in fams]


def _rmat_tile():
    """``rmat_graph(scale=9, edge_factor=6, seed=30..32)`` in one bucket:
    the refinement leaves a community of seed 32 unconnected (ROADMAP
    C.7), and none of the others'."""
    gs = [_port(rg.rmat_graph(scale=9, edge_factor=6, seed=s))
          for s in (30, 31, 32)]
    m_cap = max(g.num_edges() for g in gs)
    return [repad(g, gs[0].n_cap, m_cap) for g in gs]


# ---------------------------------------------------------------------------
# the pieces: refinement on a union, the repair of C.7, the pass loop with
# each split policy, LPA in lockstep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("anchored", [True, False])
def test_batched_plain_half_sweep_on_a_refinement_state(anchored):
    """A refinement's first sweep (the weights between communities
    zeroed, singletons, each graph's own 2m) through the batched plain
    half-sweep equals each graph's lone sweep, bit for bit."""
    graphs = _pool(4, filler_at=1)
    lone, union, u = tile_state(graphs, seed=2, refine=True)
    b, nv = u.b, u.nv
    assert bool((union[2] == 0).any())
    tok = union[8] if anchored else None
    got = _half_sweep_dense_plain(*union[:8], tok, anchored, graphs=b)
    for g, a in enumerate(lone):
        want = _half_sweep_dense_plain(*a[:8], a[8] if anchored else None,
                                       anchored)
        sl = slice(g * nv, (g + 1) * nv)
        assert torch.equal(got[0][sl] - g * nv, want[0]), g
        for i in (1, 2, 4):
            assert torch.equal(got[i][sl].view(torch.int32)
                               if i == 1 else got[i][sl],
                               want[i].view(torch.int32)
                               if i == 1 else want[i]), (g, i)
    assert bool(got[2].any())


@pytest.mark.parametrize("seed", [3, 8])
def test_refine_labels_tile_equals_lone(seed):
    """Each graph's refinement of seeded labels, on the union with the
    shared tile adjacency, is ``refine_labels`` on it alone (dense scan,
    its own 2m)."""
    graphs = _pool(5, filler_at=1)
    lone, union, u = tile_state(graphs, seed=seed)
    b, nv = u.b, u.nv
    src, dst, w, C = union[:4]
    tau = np.float32(1e-2)
    got = refine_labels_tile(src, dst, w, C, union[6], counts=u.counts,
                             tau=tau, max_iters=20,
                             adj=tile_adjacency(src, dst, b, nv))
    for g, a in enumerate(lone):
        want = refine_labels(a[0], a[1], a[2], a[3], a[6], tau=tau,
                             max_iters=20, scan="dense",
                             adj=dense_adjacency(a[0], a[1], nv))
        sl = slice(g * nv, (g + 1) * nv)
        assert torch.equal(got[sl] - g * nv, want), g


def test_split_unconnected_tile_equals_the_coo_repair():
    """Graphs whose labels leave communities unconnected (seeded labels)
    and graphs whose communities are all connected (their ``detect()``
    labels) in one tile: the dense repair of each equals the single
    graph's coo one, labels and moved vertices, and a connected graph
    keeps its labels as they were, with 0 moved."""
    graphs = _pool(6, filler_at=2)
    lone, union, u = tile_state(graphs, seed=5)
    b, nv = u.b, u.nv
    connected = {1, 2, 4}
    C_u = union[3].clone()
    for g in connected:
        d = run_detection(graphs[g], DetectOptions(scan="dense"))
        assert d.n_disconnected == 0
        C_u[g * nv:(g + 1) * nv] = d.labels + g * nv
    node_mask = torch.cat([gr.node_mask() for gr in graphs])
    adj = tile_adjacency(u.src, u.dst, b, nv)
    got, moved = _split_unconnected_tile(adj, C_u, node_mask)
    assert moved.shape == (b,)
    n_split = 0
    for g, a in enumerate(lone):
        sl = slice(g * nv, (g + 1) * nv)
        Cg = C_u[sl] - g * nv
        want, mv = _split_unconnected(a[:3], Cg, graphs[g].node_mask())
        assert torch.equal(got[sl] - g * nv, want) and moved[g] == mv, g
        if g in connected:
            assert torch.equal(got[sl], C_u[sl]) and mv == 0, g
        n_split += mv > 0
    assert n_split >= 2
    # every graph connected: the labels come back as they were
    got, moved = _split_unconnected_tile(adj, got, node_mask)
    assert not moved.any()


@pytest.mark.parametrize("split", SPLITS)
def test_louvain_tile_equals_lone_for_each_split(split):
    """``louvain_tile`` with every split policy: each graph's labels and
    stats are ``louvain_impl(scan='dense')``'s on it alone, with a
    filler that leaves the union after one pass."""
    graphs = _pool(5, filler_at=3)
    cfg = LouvainConfig(split=split)
    C, stats, u = louvain_tile(stack_graphs(graphs), cfg)
    assert u.b == len(graphs)
    for g, gr in enumerate(graphs):
        Cg, st = louvain_impl(gr, cfg, scan="dense")
        assert torch.equal(C[g], Cg) and stats[g] == st, (g, stats[g], st)
    assert stats[3]["passes"] == 1


def test_refine_tile_repairs_what_the_reference_leaves_unconnected(
        monkeypatch):
    """On the R-MAT tile the refinement leaves a community of seed 32
    unconnected: the tile's repair moves vertices of that graph only, and
    each graph's labels and stats (repair included) are the lone run's,
    with 0 disconnected."""
    seen = []
    repair = tlouvain._split_unconnected_tile

    def spy(adj, C, node_mask):
        out = repair(adj, C, node_mask)
        seen.append(out[1].copy())
        return out

    monkeypatch.setattr(tlouvain, "_split_unconnected_tile", spy)
    graphs = _rmat_tile()
    opts = _options(split="refine")
    tile = _tile_equals_alone(graphs, opts)
    assert len(seen) == 1 and seen[0][2] > 0 and not seen[0][:2].any(), seen
    assert all(d.n_disconnected == 0 for d in tile)


def _sparse_graphs(n, k, seed):
    """``k`` sparse random graphs of about ``n`` vertices in one bucket."""
    out = []
    for s in range(k):
        rng = np.random.default_rng(seed + s)
        nn = n - 13 * s
        a, c = rng.integers(0, nn, 2 * nn), rng.integers(0, nn, 2 * nn)
        keep = a != c
        out.append(from_undirected(nn, a[keep], c[keep], n_cap=n,
                                   m_cap=4 * n + 64, device="cpu"))
    return out


LPA_CASES = [("egos", 50), ("egos", 3), ("families", 50),
             ("wide-blocks", 50)]


@pytest.mark.parametrize("pool,max_iters", LPA_CASES,
                         ids=[f"{p}-{m}" for p, m in LPA_CASES])
def test_lpa_run_tile_equals_lone(pool, max_iters):
    """Each graph's LPA labels and rounds are ``lpa_run``'s on it alone:
    a filler, graphs whose loops end rounds apart, a round cap that stops
    every graph, and graphs wide enough that the hash tables come a block
    of rounds at a time (``TABLE_CELLS // nv`` rounds)."""
    graphs = {"egos": lambda: _pool(7, filler_at=5),
              "families": _families,
              "wide-blocks": lambda: _sparse_graphs(1 << 14, 3, 1)}[pool]()
    C, rounds, n_comms, u = lpa_run_tile(stack_graphs(graphs),
                                         max_iters=max_iters)
    assert u.b == len(graphs)
    for g, gr in enumerate(graphs):
        Cg, it = lpa_run(gr, max_iters=max_iters)
        assert torch.equal(C[g], Cg) and rounds[g] == it, (g, rounds[g], it)
        assert n_comms[g] == int(Cg[:int(gr.n_nodes)].max()) + 1, g
    if max_iters == 3:            # the filler stops at its second round
        assert rounds.max() == 3, rounds
    elif pool == "wide-blocks":     # past a block of table rows
        assert rounds.min() > TABLE_CELLS // u.nv, rounds
    else:
        assert len(set(rounds.tolist())) > 1, rounds


# ---------------------------------------------------------------------------
# run_detection_tile and the engine for max-quality and fast
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm", TIERS)
def test_tier_tile_of_the_six_families(algorithm):
    _tile_equals_alone(_families(), _options(algorithm))


@pytest.mark.parametrize("algorithm", TIERS)
def test_tier_tile_of_the_rmat_family(algorithm):
    """Max-quality's refined candidate is repaired on seed 32 (C.7); its
    pick and the fast tier's labels stay each graph's own."""
    tile = _tile_equals_alone(_rmat_tile(), _options(algorithm))
    if algorithm == "max-quality":
        assert all(d.n_disconnected == 0 for d in tile)


def test_max_quality_tile_picks_each_graphs_candidate():
    """The pool holds graphs where each candidate wins: the per-graph
    pick takes the refined one where its Q is at least the GSP one's, as
    ``_pick`` does, with that candidate's stats."""
    graphs = _families()
    refined = run_detection_tile(graphs, _options(split="refine"))
    standard = run_detection_tile(graphs, _options())
    tile = _tile_equals_alone(graphs, _options("max-quality"))
    took = []
    for r, s, d in zip(refined, standard, tile):
        q_r, q_s = (np.float32(x.modularity) for x in (r, s))
        pick = r if q_r >= q_s else s
        assert torch.equal(d.labels, pick.labels) and d.stats == pick.stats
        took.append(q_r >= q_s)
    assert len(set(took)) == 2, took


@pytest.mark.parametrize("algorithm", TIERS)
@pytest.mark.parametrize("sub_batch", [2, 3, 8])
def test_engine_tier_tiles_equal_detect(algorithm, sub_batch):
    """Ten graphs of different ``n_nodes`` and a filler, in tiles of
    ``sub_batch`` (a partial last tile; at 3 a last tile of one graph):
    every result is ``detect()``'s."""
    graphs = _pool(9, filler_at=4)
    eng = BatchedLouvainEngine(device="cpu", sub_batch=sub_batch)
    res = eng.detect_batch(graphs, algorithm=algorithm)
    info = eng.last_detect_info
    assert (info.route, info.n, info.algorithm) == ("tile", 10, algorithm)
    opts = DetectOptions(algorithm=algorithm)
    for g, r in zip(graphs, res):
        d = run_detection(g, opts)
        np.testing.assert_array_equal(r.C, d.labels.numpy())
        assert (r.n_communities, r.n_disconnected, r.passes, r.sweeps,
                r.split_moved) == (d.n_communities, d.n_disconnected,
                                   d.stats["passes"], d.stats["li_total"],
                                   d.stats["split_moved"])
        assert r.fraction == d.fraction and r.q == d.modularity


@pytest.mark.parametrize("algorithm", TIERS)
def test_engine_equals_reference_engine_for_tier(algorithm):
    """The engine at ``sub_batch=3`` against the reference's at the same
    width, on a pool where the reference's refinement leaves every
    community connected (its max-quality ``n_disconnected`` read 0), so
    C.7's repair changes nothing."""
    gj = _pool_j(5)
    want = jservice.BatchedLouvainEngine(sub_batch=3).detect_batch(
        gj, algorithm=algorithm)
    if algorithm == "max-quality":
        assert all(int(b.n_disconnected) == 0 for b in want)
    eng = BatchedLouvainEngine(device="cpu", sub_batch=3)
    got = eng.detect_batch([_port(g) for g in gj], algorithm=algorithm)
    assert eng.last_detect_info.route == "tile"
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.C, np.asarray(b.C))
        for f in ("n_communities", "passes", "sweeps", "split_moved",
                  "n_disconnected", "fraction"):
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.q - b.q) <= Q_ATOL


def test_standard_splits_take_the_tile_in_the_engine():
    """An engine whose options carry any split runs standard batches on
    the tile; every result is ``detect()``'s."""
    graphs = _pool(4)
    for split in ("none", "sl-lpp", "refine"):
        opts = _options(split=split)
        eng = BatchedLouvainEngine(options=opts, device="cpu", sub_batch=4)
        res = eng.detect_batch(graphs)
        assert eng.last_detect_info.route == "tile", split
        for g, r in zip(graphs, res):
            d = run_detection(g, opts)
            np.testing.assert_array_equal(r.C, d.labels.numpy())
            assert (r.split_moved, r.q) == (d.stats["split_moved"],
                                            d.modularity), split
