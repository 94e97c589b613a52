"""The batched engine's tile on the sortscan (the reference's
``jit(lax.map(vmap(...)))`` with ``scan='sort'``) held, on the CPU, to the
single-graph sortscan and to the JAX package's engine.

A tile of ``b`` graphs of one sortscan bucket runs as one union of their
live edges (``graph/container.py:GraphUnion``) and builds no ``[b, nv,
nv]`` matrix: the sortscan's half-sweep sorts the union's edges by
``(src, C[dst])`` (``core/local_move.py:_half_sweep`` with ``graphs=b``),
neighbours wake by the union's sorted ``src``, and every split is the coo
one on the union.  Each graph's outputs must be the bits of its lone
sortscan run: the half-sweep (``C_new``, Sigma, ``move``, ``want``),
``local_move_tile`` against ``local_move`` (cold, every sync mode and
prune setting) and ``warm_local_move`` (warm), ``louvain_tile`` against
``louvain_impl`` for every split policy (C.7's repair included),
``run_detection_tile`` against ``run_detection`` for every tier at widths
1, 2, 3 and 8, and ``warm_update_tile`` against ``warm_update``.  The
engine is held to the reference's engine at its ``sub_batch`` (labels and
counts exact, Q within ``Q_ATOL``), and a monkeypatched
``tile_adjacency`` shows that the route builds no dense matrix.  The pool
is small: R-MAT scales 7 and 8 and SBMs in ``Bucket(256, 1024)``, with a
``unit_graph`` filler and graphs that leave the pass loop passes apart.
"""
import importlib

import numpy as np
import pytest
import torch
from _torch_service import FakeClock, sync_service
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from _torch_tile_cases import tile_state
from test_torch_batched import _same
from test_torch_batched_tiers import _rmat_tile
from test_torch_batched_updates import KEYS, _churn, _own_q, _same_row
from test_torch_batched_updates import _to_ref
from test_torch_detect import Q_ATOL, _port

import repro.core as jcore
import repro.graph as rg
import repro.service as jservice
from repro.service.buckets import admit as j_admit
from repro_torch.core import DetectOptions, GraphUpdate, LouvainConfig
from repro_torch.core import dynamic as td
from repro_torch.core.local_move import (SYNC_PHASES, _half_sweep,
                                         _move_loop, local_move_tile)
from repro_torch.core.louvain import (SPLITS, louvain_impl, louvain_tile,
                                      refine_labels, refine_labels_tile)
from repro_torch.core.portfolio import run_detection, run_detection_tile
from repro_torch.graph.container import (GraphUnion, stack_graphs,
                                         strip_padding, union_ghosts,
                                         union_of, unit_graph)
from repro_torch.kernels import ops
from repro_torch.service import BatchedLouvainEngine, Bucket

BUCKET = (256, 1024)
SORT = DetectOptions(scan="sort")
TIERS = ("standard", "max-quality", "fast")
# the module (``repro_torch.core.louvain`` is also the function's name)
tlouvain = importlib.import_module("repro_torch.core.louvain")


def _ref_graph(s):
    """The ``s``-th reference graph of the pool: R-MAT scale 7 (128
    vertices), an SBM of ``100 + 6 s`` vertices, R-MAT scale 8 (256, the
    bucket's width), in turn."""
    if s % 3 == 0:
        return rg.rmat_graph(scale=7, edge_factor=4, seed=s)
    if s % 3 == 1:
        return rg.sbm_graph(n_nodes=100 + 6 * s, n_blocks=4, p_in=0.12,
                            p_out=0.01, seed=s)[0]
    return rg.rmat_graph(scale=8, edge_factor=2, seed=s)


def _pool_j(k):
    """``k`` reference graphs of ``Bucket(256, 1024)``."""
    return [j_admit(_ref_graph(s), [jservice.Bucket(*BUCKET)])[0]
            for s in range(k)]


def _pool(k, filler_at=None):
    graphs = [_port(g) for g in _pool_j(k)]
    if filler_at is not None:
        graphs.insert(filler_at, unit_graph(*BUCKET, device="cpu"))
    return graphs


def _tile_equals_alone(graphs, options=SORT):
    tile = run_detection_tile(graphs, options)
    assert len(tile) == len(graphs)
    for i, (g, d) in enumerate(zip(graphs, tile)):
        _same(d, run_detection(g, options), f"graph {i}")
    return tile


def _bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32) if a.is_floating_point() else a,
                       b.view(torch.int32) if b.is_floating_point() else b)


# ---------------------------------------------------------------------------
# the pieces: the half-sweep on a union, the sweep loop of a tile
# ---------------------------------------------------------------------------

HALF_SWEEPS = [(refine, target, anchored) for refine in (False, True)
               for target, anchored in ((True, True), (False, True),
                                        (False, False))]


@pytest.mark.parametrize("refine,target,anchored", HALF_SWEEPS,
                         ids=[f"{'refine' if r else 'sweep'}-{t}-{a}"
                              for r, t, a in HALF_SWEEPS])
def test_sortscan_half_sweep_on_a_union_equals_lone(refine, target,
                                                    anchored):
    """``_half_sweep(graphs=b)`` on the union of a tile gives each graph
    the bits of its lone half-sweep: ``C_new``, Sigma, ``move`` and
    ``want``, on a sweep's state (seeded labels) and on a refinement's
    (cross-community weights zeroed, singletons), gated and ungated."""
    graphs = _pool(5, filler_at=2)
    lone, union, u = tile_state(graphs, seed=4, refine=refine)
    b, nv = u.b, u.nv
    src, dst, w, C, K, Sigma, two_m, movable, tok = union
    got = _half_sweep(src, dst, w, C, K, Sigma, two_m, movable,
                      tok if target else None, anchored, graphs=b)
    assert got[3].shape == (b,)
    assert _half_sweep(src, dst, w, C, K, Sigma, two_m, movable,
                       graphs=b, gain=False)[3] is None
    moved = 0
    for g, a in enumerate(lone):
        want = _half_sweep(*a[:8], a[8] if target else None, anchored)
        sl = slice(g * nv, (g + 1) * nv)
        assert torch.equal(got[0][sl] - g * nv, want[0]), g
        for i in (1, 2, 4):
            assert _bits(got[i][sl], want[i]), (g, i)
        assert abs(float(got[3][g]) - float(want[3])) <= 1e-6, g
        moved += int(want[2].sum())
    assert moved > 0


def _union_sweep_inputs(graphs):
    u = union_of(stack_graphs(graphs))
    n = u.b * u.nv
    K = ops.segreduce_sorted(u.w, u.src, n, op="sum")
    return u, K, ops.sum_inorder_per_graph(u.w, u.counts)


LOCAL_MOVES = [(sync, prune) for sync in SYNC_PHASES
               for prune in (True, False)]


@pytest.mark.parametrize("sync,prune", LOCAL_MOVES,
                         ids=[f"{s}-{p}" for s, p in LOCAL_MOVES])
def test_local_move_tile_sortscan_equals_lone(sync, prune):
    """Cold, from singletons: each graph's labels, Sigma, ``l_i`` and
    sweeps are ``local_move(scan='sort')``'s on it alone, and the graphs
    converge sweeps apart."""
    graphs = _pool(6, filler_at=4)
    u, K, two_m = _union_sweep_inputs(graphs)
    b, nv = u.b, u.nv
    ids = torch.arange(b * nv, dtype=torch.int32)
    tau = np.float32(1e-2)
    C, Sigma, li, sweeps = local_move_tile(
        u.src, u.dst, u.w, ids, K, K, two_m, counts=u.counts, tau=tau,
        sync=sync, prune=prune, scan="sort")
    off = u.edge_offsets
    for g in range(b):
        e = slice(off[g], off[g + 1])
        src, dst, w = u.src[e] - g * nv, u.dst[e] - g * nv, u.w[e]
        Kg = K[g * nv:(g + 1) * nv]
        Cg, Sg, lig, itg = _move_loop(
            src, dst, w, torch.arange(nv, dtype=torch.int32), Kg, Kg,
            ops.sum_inorder(w), tau=tau, max_iters=20,
            phases=SYNC_PHASES[sync], prune=prune,
            active0=torch.ones(nv, dtype=torch.bool), warm=False,
            scan="sort", adj=None)
        sl = slice(g * nv, (g + 1) * nv)
        assert torch.equal(C[sl] - g * nv, Cg), g
        assert _bits(Sigma[sl], Sg), g
        assert (li[g], sweeps[g]) == (lig, itg), g
    assert len(set(sweeps.tolist())) > 1, sweeps


@pytest.mark.parametrize("max_iters", [10, 3])
def test_local_move_tile_sortscan_warm_equals_warm_local_move(max_iters):
    """``local_move_tile(scan='sort', active0=, warm=True)`` gives each
    graph the bits of ``warm_local_move(scan='sort')`` alone from seeded
    labels and awake sets; one awake set is all False (2 sweeps, no
    move), and a cap of 3 sweeps stops the others."""
    graphs = _pool(5)
    b, nv = len(graphs), graphs[0].nv
    rng = np.random.default_rng(11 + max_iters)
    C = np.stack([rng.integers(0, int(g.n_nodes), nv) for g in graphs]
                 ).astype(np.int32)
    active = rng.random((b, nv)) < 0.4
    active[2] = False
    u = union_of(stack_graphs(graphs))
    n = b * nv
    C0 = torch.from_numpy(C).view(n) + torch.arange(
        b, dtype=torch.int32).repeat_interleave(nv) * nv
    ghosts = union_ghosts(b, nv, "cpu")
    C0[ghosts.long()] = ghosts
    K = ops.segreduce_sorted(u.w, u.src, n, op="sum")
    Sigma0 = ops.segment_sum_inorder(K, C0, n)
    two_m = torch.stack([g.total_weight_2m() for g in graphs])
    Ct, St, _, sweeps = local_move_tile(
        u.src, u.dst, u.w, C0, K, Sigma0, two_m, counts=u.counts, tau=1e-3,
        max_iters=max_iters, scan="sort",
        active0=torch.from_numpy(active).view(n), warm=True)
    for i, g in enumerate(graphs):
        live = strip_padding(g.src, g.dst, g.w, g.ghost)
        Cg, Sg, itg = td.warm_local_move(
            *live, torch.from_numpy(C[i]), g.total_weight_2m(),
            torch.from_numpy(active[i]), max_iters=max_iters, scan="sort")
        sl = slice(i * nv, (i + 1) * nv)
        assert torch.equal(Ct[sl] - i * nv, Cg), i
        assert _bits(St[sl], Sg), i
        assert sweeps[i] == itg, i
    assert sweeps[2] == 2 and torch.equal(Ct[2 * nv:3 * nv],
                                          C0[2 * nv:3 * nv])
    assert (sweeps == max_iters).any(), sweeps


def test_local_move_tile_refuses_an_unknown_scan():
    graphs = _pool(2)
    u, K, two_m = _union_sweep_inputs(graphs)
    ids = torch.arange(2 * u.nv, dtype=torch.int32)
    with pytest.raises(ValueError, match="scan must be"):
        local_move_tile(u.src, u.dst, u.w, ids, K, K, two_m,
                        counts=u.counts, tau=1e-2, scan="auto")


@pytest.mark.parametrize("seed", [3, 8])
def test_refine_labels_tile_sortscan_equals_lone(seed):
    """Each graph's refinement of seeded labels on the union is
    ``refine_labels(scan='sort')`` on it alone (its own 2m)."""
    graphs = _pool(5, filler_at=1)
    lone, union, u = tile_state(graphs, seed=seed)
    nv = u.nv
    src, dst, w, C = union[:4]
    tau = np.float32(1e-2)
    got = refine_labels_tile(src, dst, w, C, union[6], counts=u.counts,
                             tau=tau, max_iters=20, scan="sort")
    for g, a in enumerate(lone):
        want = refine_labels(a[0], a[1], a[2], a[3], a[6], tau=tau,
                             max_iters=20, scan="sort")
        sl = slice(g * nv, (g + 1) * nv)
        assert torch.equal(got[sl] - g * nv, want), g


# ---------------------------------------------------------------------------
# the pass loop and run_detection_tile against the lone runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", SPLITS)
def test_louvain_tile_sortscan_equals_lone_for_each_split(split):
    """``louvain_tile(scan='sort')`` with every split policy: each graph's
    labels and stats are ``louvain_impl(scan='sort')``'s on it alone, with
    a filler that leaves the union after one pass and graphs that leave
    it passes apart."""
    graphs = _pool(6, filler_at=3)
    cfg = LouvainConfig(split=split)
    C, stats, u = louvain_tile(stack_graphs(graphs), cfg, scan="sort")
    assert u.b == len(graphs)
    for g, gr in enumerate(graphs):
        Cg, st = louvain_impl(gr, cfg, scan="sort")
        assert torch.equal(C[g], Cg) and stats[g] == st, (g, stats[g], st)
    passes = [s["passes"] for s in stats]
    assert passes[3] == 1 and len(set(passes)) > 2, passes


def test_louvain_tile_sortscan_with_a_split_round_cap():
    """``split_max_iters`` caps the coo split's rounds on the union as on
    each graph alone."""
    graphs = _pool(4)
    for split in ("sp-lp", "sl-lpp"):
        cfg = LouvainConfig(split=split, split_max_iters=2)
        C, stats, _ = louvain_tile(stack_graphs(graphs), cfg, scan="sort")
        for g, gr in enumerate(graphs):
            Cg, st = louvain_impl(gr, cfg, scan="sort")
            assert torch.equal(C[g], Cg) and stats[g] == st, (split, g)


def test_sortscan_refine_tile_repairs_what_the_reference_leaves_unconnected(
        monkeypatch):
    """On the R-MAT tile the refinement leaves a community of seed 32
    unconnected: the sortscan tile's repair runs the coo split on the
    union, moves vertices of that graph only, and each graph's labels
    and stats are the lone sortscan run's, with 0 disconnected."""
    seen = []
    repair = tlouvain._split_unconnected_tile

    def spy(edges, C, node_mask):
        out = repair(edges, C, node_mask)
        seen.append((type(edges), out[1].copy()))
        return out

    monkeypatch.setattr(tlouvain, "_split_unconnected_tile", spy)
    opts = DetectOptions(scan="sort", louvain=LouvainConfig(split="refine"))
    tile = _tile_equals_alone(_rmat_tile(), opts)
    assert len(seen) == 1 and seen[0][0] is GraphUnion, seen
    moved = seen[0][1]
    assert moved[2] > 0 and not moved[:2].any(), moved
    assert all(d.n_disconnected == 0 for d in tile)


@pytest.mark.parametrize("b", [1, 2, 3, 8])
def test_sortscan_tile_equals_detect_at_width(b):
    _tile_equals_alone(_pool(b))


@pytest.mark.parametrize("algorithm", TIERS)
def test_sortscan_tile_for_each_tier(algorithm):
    """Every tier of a tile with a filler: each graph's ``Detection`` is
    ``run_detection``'s; standard and max-quality leave nothing
    disconnected."""
    tile = _tile_equals_alone(_pool(7, filler_at=5),
                              DetectOptions(scan="sort",
                                            algorithm=algorithm))
    if algorithm != "fast":
        assert all(d.n_disconnected == 0 for d in tile)


# ---------------------------------------------------------------------------
# the warm updates of a tile
# ---------------------------------------------------------------------------

def _update_items(seed=0):
    """Six update items of the pool: warm starts from the cold sortscan
    labels (even) or seeded random labels (odd), one update kind each."""
    rng = np.random.default_rng(seed)
    out = []
    for i, g in enumerate(_pool(6)):
        if i % 2 == 0:
            C = run_detection(g, SORT).labels.numpy()
        else:
            C = rng.integers(0, int(g.n_nodes), g.nv).astype(np.int32)
        out.append(_churn(g, C, rng, ("vertex", "none", "delete", "insert",
                                      "vertex", "delete")[i]))
    return out


def test_warm_update_tile_sortscan_equals_lone_and_reference():
    """``warm_update_tile(scan='sort')`` gives each graph the bits of
    ``warm_update(scan='sort')`` alone, and the reference's
    ``warm_update_impl(scan='sort')`` (Q within ``Q_ATOL``)."""
    import jax
    import jax.numpy as jnp

    from repro.core import dynamic as jd

    items = _update_items()
    graphs = [g for g, _, _ in items]
    C = torch.from_numpy(np.stack([C for _, C, _ in items]))
    t = torch.from_numpy(np.stack([t for _, _, t in items]))
    rows = td.warm_update_tile(graphs, C, t, scan="sort")
    assert len({int(g.n_nodes) for g in graphs}) > 1
    fn = jax.jit(lambda g, C, t: jd.warm_update_impl(g, C, t, scan="sort"))
    for i, ((g, Ci, ti), row) in enumerate(zip(items, rows)):
        lone = td.warm_update(g, torch.from_numpy(Ci), torch.from_numpy(ti),
                              scan="sort")
        _same_row(row, lone, i)
        want = {k: np.asarray(v) for k, v in fn(
            _to_ref(g), jnp.asarray(Ci), jnp.asarray(ti)).items()}
        np.testing.assert_array_equal(row["C"].numpy(), want["C"])
        for k in KEYS:
            if k != "q":
                assert row[k] == want[k].item(), (i, k)
        assert abs(row["q"] - float(want["q"])) <= Q_ATOL
        assert row["q"] == _own_q(g, row["C"])
        assert row["n_disconnected"] == 0
    assert rows[1]["n_affected"] == 0 and rows[1]["iterations"] == 2


# ---------------------------------------------------------------------------
# the engine: routes, the reference's engine, no dense matrix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algorithm,sub_batch", [("standard", 2),
                                                 ("standard", 3),
                                                 ("max-quality", 3)])
def test_engine_sortscan_equals_reference_engine(algorithm, sub_batch):
    """The engine's sortscan tiles against the reference's engine at the
    same width with ``scan='sort'``, on a pool where the reference's
    refinement leaves every community connected (C.7's repair changes
    nothing): labels, counts, passes, sweeps and split moves equal, Q
    within ``Q_ATOL``."""
    gj = _pool_j(7)
    want = jservice.BatchedLouvainEngine(
        sub_batch=sub_batch, options=jcore.DetectOptions(scan="sort")
    ).detect_batch(gj, algorithm=algorithm)
    assert all(int(b.n_disconnected) == 0 for b in want)
    eng = BatchedLouvainEngine(device="cpu", sub_batch=sub_batch,
                               options=SORT)
    got = eng.detect_batch([_port(g) for g in gj], algorithm=algorithm)
    info = eng.last_detect_info
    assert (info.route, info.capacity) == (
        "tile", -(-7 // sub_batch) * sub_batch)
    assert eng.scan_for(Bucket(*BUCKET)) == "sort"
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.C, np.asarray(b.C))
        for f in ("n_communities", "passes", "sweeps", "split_moved",
                  "n_disconnected", "fraction"):
            assert getattr(a, f) == getattr(b, f), f
        assert abs(a.q - b.q) <= Q_ATOL


def test_engine_sortscan_update_tile_equals_reference_and_loop():
    """``update_batch`` on the sortscan at ``sub_batch=4`` (tiles of 4
    and 2) against the reference engine at its width and the port's
    loop: labels and counts exact, Q within ``Q_ATOL``, nothing
    disconnected."""
    items = _update_items(seed=3)
    want = jservice.BatchedLouvainEngine(
        sub_batch=4, options=jcore.DetectOptions(scan="sort")).update_batch(
        [(_to_ref(g), C, t) for g, C, t in items])
    eng = BatchedLouvainEngine(device="cpu", sub_batch=4, options=SORT)
    got = eng.update_batch(items)
    info = eng.last_update_info
    assert (info.route, info.n, info.capacity) == ("tile", 6, 8)
    loop = BatchedLouvainEngine(device="cpu", options=SORT)
    lone = loop.update_batch(items)
    assert loop.last_update_info.route == "loop"
    for i, (a, b, x) in enumerate(zip(got, want, lone)):
        np.testing.assert_array_equal(a.C, x.C)
        assert all(getattr(a, k) == getattr(x, k) for k in KEYS), i
        np.testing.assert_array_equal(a.C, np.asarray(b.C))
        for k in KEYS:
            if k != "q":
                assert getattr(a, k) == getattr(b, k), (i, k)
        assert abs(a.q - b.q) <= Q_ATOL
        assert a.n_disconnected == 0


def test_sortscan_route_builds_no_dense_matrix(monkeypatch):
    """With every builder of a ``[b, nv, nv]`` or ``[nv, nv]`` matrix and
    the dense sweep made to raise, the engine's sortscan tiles still run
    every tier, every split policy and ``update_batch``, each result the
    loop's (computed before the patch)."""
    graphs = _pool(5, filler_at=1)
    items = _update_items(seed=5)
    loop = BatchedLouvainEngine(device="cpu", options=SORT)
    cases = [(SORT, a) for a in TIERS] + [
        (DetectOptions(scan="sort", louvain=LouvainConfig(split=s)),
         "standard") for s in ("none", "sp-lpp", "sl-pj", "refine")]
    want = [BatchedLouvainEngine(device="cpu", options=o).detect_batch(
        graphs, algorithm=a) for o, a in cases]
    want_upd = loop.update_batch(items)

    def refuse(*args, **kw):
        raise AssertionError("the sortscan tile built a dense matrix")

    for mod, names in (
            ("repro_torch.core.local_move",
             ("tile_adjacency", "dense_adjacency", "_half_sweep_dense",
              "wake_neighbours_tile")),
            ("repro_torch.core.louvain",
             ("tile_adjacency", "dense_adjacency", "split_labels_tile")),
            ("repro_torch.core.dynamic",
             ("tile_adjacency", "dense_adjacency", "split_labels_tile")),
            ("repro_torch.core.split", ("_same_community_adjacency",))):
        m = importlib.import_module(mod)
        for name in names:
            monkeypatch.setattr(m, name, refuse)
    for (opts, alg), w in zip(cases, want):
        eng = BatchedLouvainEngine(device="cpu", sub_batch=4, options=opts)
        got = eng.detect_batch(graphs, algorithm=alg)
        assert eng.last_detect_info.route == "tile"
        for a, b in zip(got, w):
            np.testing.assert_array_equal(a.C, b.C)
            assert (a.passes, a.sweeps, a.split_moved, a.q) == (
                b.passes, b.sweeps, b.split_moved, b.q), (alg, opts)
    eng = BatchedLouvainEngine(device="cpu", sub_batch=4, options=SORT)
    got = eng.update_batch(items)
    assert eng.last_update_info.route == "tile"
    for a, b in zip(got, want_upd):
        np.testing.assert_array_equal(a.C, b.C)
        assert all(getattr(a, k) == getattr(b, k) for k in KEYS)


def test_engine_sortscan_routes_and_warm_up():
    """Every tier and the update batches of a sortscan bucket take the
    tile at ``sub_batch > 1`` and the loop at 1; ``warm()`` and
    ``warm_updates()`` dispatch one full filler tile on it."""
    b = Bucket(*BUCKET)
    eng = BatchedLouvainEngine(device="cpu", sub_batch=4, algorithms=TIERS)
    one = BatchedLouvainEngine(device="cpu", algorithms=TIERS)
    assert eng.scan_for(b) == one.scan_for(b) == "sort"
    for alg in TIERS:
        assert (eng.route_for(b, alg), one.route_for(b, alg)) == (
            "tile", "loop"), alg
    assert (eng.update_route_for(b), one.update_route_for(b)) == (
        "tile", "loop")
    assert eng.warm(b) == 3
    info = eng.last_detect_info
    assert (info.n, info.capacity, info.route) == (4, 4, "tile")
    assert eng.warm_updates(b) == 1
    info = eng.last_update_info
    assert (info.n, info.capacity, info.route) == (4, 4, "tile")


def test_frontend_sortscan_updates_take_the_tile():
    """``CommunityService`` on a sortscan bucket with ``sub_batch=4``:
    the detect batch and the queued updates run on the tile and commit
    the entries of ``update_batch_size=1`` and ``sub_batch=1``."""
    gj = _pool_j(4)
    rng = np.random.default_rng(7)
    upds = []
    for g in gj:
        n = int(g.n_nodes)
        u, v = rng.integers(0, n, 6), rng.integers(0, n, 6)
        keep = u != v
        upds.append(GraphUpdate(u=u[keep], v=v[keep],
                                dw=np.ones(int(keep.sum()), np.float32),
                                add=1, remove=[int(rng.integers(0, n))]))

    def serve(update_batch_size, sub_batch):
        svc = sync_service(True, clock=FakeClock(), batch_size=4,
                           max_delay_s=10.0, sub_batch=sub_batch,
                           detect=SORT, buckets=(BUCKET,),
                           update_batch_size=update_batch_size)
        for i, g in enumerate(gj):
            svc.submit_detect(f"g{i}", _port(g))
        svc.drain()
        assert svc.engine.last_detect_info.route == (
            "tile" if sub_batch > 1 else "loop")
        for i, upd in enumerate(upds):
            svc.submit_update(f"g{i}", upd)
        svc.drain()
        return svc

    one, four = serve(1, 1), serve(4, 4)
    assert four.metrics.n_update_batches >= 1
    assert four.engine.last_update_info.route == "tile"
    assert four.engine.last_update_info.n > 1
    for i in range(4):
        a, b = one.result(f"g{i}"), four.result(f"g{i}")
        np.testing.assert_array_equal(a.C, b.C)
        assert (a.q, a.n_communities, a.n_disconnected, a.version) == (
            b.q, b.n_communities, b.n_disconnected, b.version)
        assert a.version == 2 and b.n_disconnected == 0
