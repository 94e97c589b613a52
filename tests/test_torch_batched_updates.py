"""The batched engine's warm updates in lane-parallel tiles (the
reference's ``jit(lax.map(vmap(warm_update_impl)))``) held, on the CPU, to
``warm_update`` of each graph alone, to the JAX package's
``warm_update_impl`` and engine, and to the store's immediate path.

A tile of ``b`` dense-scan graphs runs as one union of their live edges
(``core/dynamic.py:warm_update_tile``): one screening, one warm sweep loop
(``core/local_move.py:local_move_tile`` with ``active0=`` and
``warm=True``), one split, renumber, detector and modularity.  Each
graph's labels, counts, ``fraction``, ``q``, ``iterations``,
``n_affected`` and ``split_moved`` must be the bits of ``warm_update`` on
it alone; against the reference every integer and the labels are exact and
``q`` is within ``Q_ATOL`` (1e-6; its last flat sum folds in another
order, ROADMAP C.8) and equal to the port's own ``modularity``.  The cases
are small: ego-nets in ``Bucket(64, 512)``, an SBM and R-MAT scale 6 in
``Bucket(128, 4096)``, with warm starts from the cold labels and from
seeded random labels (which run to ``max_iters``), vertex additions and
removals (so ``n_nodes`` differs inside a tile), edge deletions and
insertions, an untouched graph and an intra-community bridge deletion.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_service import FakeClock, ego, sync_service
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import Q_ATOL, _port

import repro.core as jcore
import repro.graph as rg
import repro.service as jservice
from repro.core import dynamic as jd
from repro.graph.container import Graph as JGraph
from repro.service.buckets import admit as j_admit
from repro_torch.core import DetectOptions, GraphUpdate, detect
from repro_torch.core import dynamic as td
from repro_torch.core.local_move import local_move_tile, tile_adjacency
from repro_torch.core.modularity import modularity
from repro_torch.graph.container import (stack_graphs, strip_padding,
                                         union_ghosts, union_of)
from repro_torch.kernels import ops
from repro_torch.service import BatchedLouvainEngine, Bucket, ResultStore
from repro_torch.telemetry import InMemorySink, Telemetry

DENSE = DetectOptions(scan="dense")
KEYS = ("n_communities", "n_disconnected", "fraction", "q", "iterations",
        "n_affected", "split_moved")

# (generator of the seed-th reference graph, bucket)
FAMILIES = {
    "ego": (lambda s: rg.sbm_graph(n_nodes=24 + (7 * s) % 37, n_blocks=3,
                                   p_in=0.4, p_out=0.04, seed=s)[0],
            (64, 512)),
    "sbm": (lambda s: rg.sbm_graph(n_nodes=90 + 5 * s, n_blocks=4,
                                   p_in=0.3, p_out=0.03, seed=s)[0],
            (128, 4096)),
    "rmat": (lambda s: rg.rmat_graph(scale=6, edge_factor=8, seed=s),
             (128, 4096)),
}


def _graphs(family, k=5):
    """``k`` port graphs of one family, in its bucket."""
    make, bucket = FAMILIES[family]
    return [_port(j_admit(make(s), [jservice.Bucket(*bucket)])[0])
            for s in range(k)]


def _to_ref(g) -> JGraph:
    """A port graph as the reference's (the same arrays)."""
    return JGraph(src=jnp.asarray(g.src.numpy()),
                  dst=jnp.asarray(g.dst.numpy()),
                  w=jnp.asarray(g.w.numpy()),
                  n_nodes=jnp.int32(int(g.n_nodes)), n_cap=g.n_cap,
                  m_cap=g.m_cap)


def _churn(g, C, rng, kind):
    """One seeded update of ``kind`` on ``g`` at labels ``C``, folded on
    the host: ``(graph, C_prev, touched)``.  'none' touches nothing,
    'vertex' removes three vertices and adds two wired to survivors (plus
    three insertions), 'delete' deletes four live edges, 'insert' inserts
    five."""
    n, nv = int(g.n_nodes), g.nv
    if kind == "none":
        return g, C, np.zeros(nv, bool)
    src, dst, w = (t.numpy() for t in (g.src, g.dst, g.w))
    if kind == "vertex":        # the new vertices are n - 3 and n - 2
        upd = GraphUpdate(
            u=np.concatenate([[n - 3, n - 3, n - 2],
                              rng.integers(0, n - 3, 3)]),
            v=rng.integers(0, n - 3, 6), dw=np.ones(6, np.float32), add=2,
            remove=np.sort(rng.choice(n, 3, replace=False)))
    elif kind == "delete":
        idx = rng.choice(np.flatnonzero((src < g.n_cap) & (src < dst)), 4,
                         replace=False)
        upd = GraphUpdate(u=src[idx], v=dst[idx], dw=-w[idx])
    else:
        upd = GraphUpdate(u=rng.integers(0, n, 5), v=rng.integers(0, n, 5),
                          dw=np.ones(5, np.float32))
    g2, C2, t2, _ = td.prepare_graph_update(g, C, upd)
    return g2, np.asarray(C2, np.int32), t2


def _items(family, seed=0):
    """Five update items of one family: warm starts from the cold labels
    (even) or seeded random labels (odd), one update kind each."""
    rng = np.random.default_rng(seed)
    out = []
    for i, g in enumerate(_graphs(family)):
        if i % 2 == 0:
            C = detect(g, options=DENSE, device="cpu").labels.numpy()
        else:
            C = rng.integers(0, int(g.n_nodes), g.nv).astype(np.int32)
        out.append(_churn(g, C, rng, ("vertex", "none", "delete", "insert",
                                      "vertex")[i]))
    return out


@functools.lru_cache(maxsize=None)
def _ref_warm_update(scan):
    return jax.jit(functools.partial(jd.warm_update_impl, scan=scan))


def _same_row(a, b, what=""):
    """Two ``warm_update`` dicts: labels and every key, floats by bits."""
    assert torch.equal(a["C"], b["C"]), what
    for k in KEYS:
        x, y = a[k], b[k]
        assert type(x) is type(y), (what, k)
        if isinstance(x, float):
            assert np.float32(x).view(np.int32) == \
                np.float32(y).view(np.int32), (what, k, x, y)
        else:
            assert x == y, (what, k, x, y)


def _own_q(g, C) -> float:
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    return float(modularity(*live, torch.as_tensor(C)))


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """Each family's items and the reference's ``warm_update_impl`` of
    each (one compile a bucket)."""
    items = _items(request.param)
    fn = _ref_warm_update("dense")
    ref = [{k: np.asarray(v) for k, v in fn(
        _to_ref(g), jnp.asarray(C), jnp.asarray(t)).items()}
        for g, C, t in items]
    return request.param, items, ref


# ---------------------------------------------------------------------------
# the pieces: the screening on a union, the warm sweep loop of a tile
# ---------------------------------------------------------------------------

def test_affected_mask_on_union_equals_lone(family):
    """The union's screening set is each graph's, slot for slot, so
    ``n_affected`` is each graph's count."""
    _, items, _ = family
    graphs = [g for g, _, _ in items]
    u = union_of(stack_graphs(graphs))
    nv = u.nv
    base = torch.arange(len(items), dtype=torch.int32)[:, None] * nv
    C_u = (torch.from_numpy(np.stack([C for _, C, _ in items])) + base
           ).view(-1)
    t_u = torch.from_numpy(np.stack([t for _, _, t in items])).view(-1)
    got = td.affected_mask_edges(u.src, u.dst, C_u, t_u).view(-1, nv)
    for i, (g, C, t) in enumerate(items):
        want = td.affected_mask(g, torch.from_numpy(C), torch.from_numpy(t))
        assert torch.equal(got[i], want), i
    assert int(got[1].sum()) == 0            # the untouched item


@pytest.mark.parametrize("family_name", list(FAMILIES))
def test_local_move_tile_warm_equals_warm_local_move(family_name):
    """``local_move_tile(active0=, warm=True)`` gives each graph the bits
    of ``warm_local_move`` alone (``C``, ``Sigma``, sweeps) from seeded
    random labels and awake sets; one awake set is all False (no mover,
    2 sweeps) and some graphs run to ``max_iters``."""
    graphs = _graphs(family_name)
    b, nv = len(graphs), graphs[0].nv
    rng = np.random.default_rng(11)
    C = np.stack([rng.integers(0, int(g.n_nodes), nv) for g in graphs]
                 ).astype(np.int32)
    active = rng.random((b, nv)) < 0.4
    active[2] = False
    u = union_of(stack_graphs(graphs))
    n = b * nv
    C0 = torch.from_numpy(C).view(n) + torch.arange(b, dtype=torch.int32
                                                    ).repeat_interleave(nv) * nv
    ghosts = union_ghosts(b, nv, "cpu")
    C0[ghosts.long()] = ghosts
    K = ops.segreduce_sorted(u.w, u.src, n, op="sum")
    Sigma0 = ops.segment_sum_inorder(K, C0, n)
    two_m = torch.stack([g.total_weight_2m() for g in graphs])
    max_iters = 10
    Ct, St, _, sweeps = local_move_tile(
        u.src, u.dst, u.w, C0, K, Sigma0, two_m, counts=u.counts, tau=1e-3,
        max_iters=max_iters, adj=tile_adjacency(u.src, u.dst, b, nv),
        active0=torch.from_numpy(active).view(n), warm=True)
    for i, g in enumerate(graphs):
        live = strip_padding(g.src, g.dst, g.w, g.ghost)
        Cg, Sg, itg = td.warm_local_move(
            *live, torch.from_numpy(C[i]), g.total_weight_2m(),
            torch.from_numpy(active[i]), max_iters=max_iters, scan="dense")
        sl = slice(i * nv, (i + 1) * nv)
        assert torch.equal(Ct[sl] - i * nv, Cg), i
        assert torch.equal(St[sl].view(torch.int32), Sg.view(torch.int32)), i
        assert sweeps[i] == itg, i
    assert sweeps[2] == 2 and torch.equal(Ct[2 * nv:3 * nv], C0[2 * nv:3 * nv])
    assert (sweeps == max_iters).any(), sweeps


# ---------------------------------------------------------------------------
# warm_update_tile against warm_update alone and the reference
# ---------------------------------------------------------------------------

def test_warm_update_tile_equals_lone_and_reference(family):
    name, items, ref = family
    graphs = [g for g, _, _ in items]
    C = torch.from_numpy(np.stack([C for _, C, _ in items]))
    t = torch.from_numpy(np.stack([t for _, _, t in items]))
    rows = td.warm_update_tile(graphs, C, t)
    assert len({int(g.n_nodes) for g in graphs}) > 1      # n_nodes differ
    for i, ((g, Ci, ti), row, want) in enumerate(zip(items, rows, ref)):
        lone = td.warm_update(g, torch.from_numpy(Ci), torch.from_numpy(ti),
                              scan="dense")
        _same_row(row, lone, (name, i))
        np.testing.assert_array_equal(row["C"].numpy(), want["C"])
        for k in KEYS:
            if k != "q":
                assert row[k] == want[k].item(), (name, i, k)
        assert abs(row["q"] - float(want["q"])) <= Q_ATOL
        assert row["q"] == _own_q(g, row["C"])
        assert row["n_disconnected"] == 0
    assert rows[1]["n_affected"] == 0 and rows[1]["iterations"] == 2
    # a stack_graphs result is taken as it is
    again = td.warm_update_tile(stack_graphs(graphs), C, t)
    for a, b in zip(again, rows):
        _same_row(a, b, name)


# ---------------------------------------------------------------------------
# the engine's tile route, against the reference engine and the store
# ---------------------------------------------------------------------------

def _ring_with_bridge():
    """ring_of_cliques(30, 4) in ``Bucket(128, 4096)`` at its cold labels,
    whose communities hold ring bridges, and one such bridge."""
    g = _port(rg.ring_of_cliques(30, 4, n_cap=128, m_cap=4096))
    C = detect(g, options=DENSE, device="cpu").labels.numpy()
    bridges = [(c * 4, ((c + 1) % 30) * 4) for c in range(30)]
    intra = [(u, v) for u, v in bridges if C[u] == C[v]]
    assert intra
    return g, C, intra[0]


def _engine_case():
    """Two stores holding the same five entries in ``Bucket(128, 4096)``
    (four SBM graphs, the ring of cliques) and one update each: vertex
    additions and removals on two, none on one, insertions on one, an
    intra-community bridge deletion on the ring."""
    graphs = _graphs("sbm", 4)
    ring, C_ring, (bu, bv) = _ring_with_bridge()
    stores = [ResultStore(options=DENSE, device="cpu") for _ in range(2)]
    rng = np.random.default_rng(5)
    upds = []
    for i, g in enumerate(graphs + [ring]):
        C = (C_ring if i == 4 else
             detect(g, options=DENSE, device="cpu").labels.numpy())
        for s in stores:
            s.put(f"g{i}", g, C, n_communities=int(C.max()), n_disconnected=0,
                  q=0.0)
        n = int(g.n_nodes)
        if i == 4:
            upd = GraphUpdate(u=[bu], v=[bv], dw=np.float32([-1.0]))
        elif i == 2:
            upd = GraphUpdate()
        elif i == 3:
            upd = GraphUpdate(u=rng.integers(0, n, 6),
                              v=rng.integers(0, n, 6),
                              dw=np.ones(6, np.float32))
        else:           # the new vertices are [n - 2, n - 1 + i)
            new = list(range(n - 2, n - 1 + i))
            upd = GraphUpdate(u=new + [0], v=[1] * len(new) + [n - 2 + i],
                              dw=np.ones(len(new) + 1, np.float32),
                              add=1 + i, remove=[3 + i, 40 + i])
        upds.append(upd)
    plans = [stores[0].prepare_update(f"g{i}", u) for i, u in enumerate(upds)]
    return stores, upds, plans


@pytest.fixture(scope="module")
def engine_case():
    """The case, and the reference engine's ``update_batch`` of it at
    ``sub_batch=4`` (one compile for the module)."""
    stores, upds, plans = _engine_case()
    want = jservice.BatchedLouvainEngine(
        sub_batch=4, options=jcore.DetectOptions(scan="dense")).update_batch(
        [(_to_ref(p.graph), p.C_prev, p.touched) for p in plans])
    return stores, upds, plans, want


def test_engine_update_tile_equals_reference_and_immediate(engine_case):
    stores, upds, plans, want = engine_case
    items = [(p.graph, p.C_prev, p.touched) for p in plans]
    assert len({int(g.n_nodes) for g, _, _ in items}) > 1
    assert not items[2][2].any()                     # the untouched item
    eng = BatchedLouvainEngine(device="cpu", sub_batch=4, options=DENSE)
    bucket = Bucket(128, 4096)
    assert eng.update_route_for(bucket) == "tile"
    got = eng.update_batch(items)
    info = eng.last_update_info
    assert (info.kind, info.route, info.n, info.capacity) == (
        "update", "tile", 5, 8)
    immediate = stores[1]
    for i, (a, b, (g, C, t)) in enumerate(zip(got, want, items)):
        lone = td.warm_update(g, torch.from_numpy(C), torch.from_numpy(t),
                              scan="dense")
        np.testing.assert_array_equal(a.C, lone["C"].numpy())
        for k in KEYS:
            assert getattr(a, k) == lone[k], (i, k)
        np.testing.assert_array_equal(a.C, np.asarray(b.C))
        for k in KEYS:
            if k != "q":
                assert getattr(a, k) == getattr(b, k), (i, k)
        assert abs(a.q - b.q) <= Q_ATOL and a.q == _own_q(g, a.C)
        assert a.n_disconnected == 0
        e = immediate.apply_update(f"g{i}", upds[i])
        np.testing.assert_array_equal(e.C, a.C)
        assert (e.n_communities, e.n_disconnected, e.q) == (
            a.n_communities, a.n_disconnected, a.q)
    assert got[2].n_affected == 0 and got[2].iterations == 2
    assert got[4].n_communities > len(set(plans[4].C_prev[:120].tolist()))


@pytest.mark.parametrize("sub_batch", [2, 3, 8])
def test_engine_update_tiles_equal_loop(engine_case, sub_batch):
    """Every width cuts the batch into tiles of at most ``sub_batch`` (at
    3, a last tile of two; at 2, of one) with the loop's results."""
    _, _, plans, _ = engine_case
    items = [(p.graph, p.C_prev, p.touched) for p in plans]
    loop = BatchedLouvainEngine(device="cpu", sub_batch=1, options=DENSE)
    want = loop.update_batch(items)
    assert loop.last_update_info.route == "loop"
    eng = BatchedLouvainEngine(device="cpu", sub_batch=sub_batch,
                               options=DENSE)
    got = eng.update_batch(items)
    info = eng.last_update_info
    assert (info.route, info.capacity) == ("tile",
                                           -(-5 // sub_batch) * sub_batch)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.C, b.C)
        assert all(getattr(a, k) == getattr(b, k) for k in KEYS)


def test_update_routes_sortscan_and_width_one_keep_the_loop():
    """The routes of an update batch: at ``sub_batch > 1`` the sortscan
    bucket takes the tile as the dense one does, and width 1 (the CPU's
    auto width) keeps the loop on both; every result is ``warm_update``'s
    with the sortscan."""
    g = j_admit(rg.sbm_graph(n_nodes=96, n_blocks=3, p_in=0.08, p_out=0.01,
                             seed=5)[0], [jservice.Bucket(256, 1024)])[0]
    g = _port(g)
    eng = BatchedLouvainEngine(device="cpu", sub_batch=4)
    assert eng.scan_for(Bucket(256, 1024)) == "sort"
    assert eng.update_route_for(Bucket(256, 1024)) == "tile"
    assert eng.update_route_for(Bucket(64, 512)) == "tile"
    for bucket in (Bucket(64, 512), Bucket(256, 1024)):
        assert BatchedLouvainEngine(device="cpu").update_route_for(
            bucket) == "loop"
    nv = g.nv
    items = [(g, np.arange(nv, dtype=np.int32), np.eye(nv, dtype=bool)[k])
             for k in (0, 7)]
    got = eng.update_batch(items)
    info = eng.last_update_info
    assert (info.route, info.capacity) == ("tile", 4)
    loop = BatchedLouvainEngine(device="cpu").update_batch(items)
    for (gg, C, t), r, x in zip(items, got, loop):
        np.testing.assert_array_equal(r.C, x.C)
        assert all(getattr(r, k) == getattr(x, k) for k in KEYS)
        lone = td.warm_update(gg, torch.from_numpy(C), torch.from_numpy(t),
                              scan="sort")
        np.testing.assert_array_equal(r.C, lone["C"].numpy())
        assert all(getattr(r, k) == lone[k] for k in KEYS)


def test_update_counters_equal_on_both_routes(engine_case):
    """``_note_dispatch`` emits the same sweeps, affected vertices and
    split moves for one batch on the loop and the tile."""
    _, _, plans, _ = engine_case
    items = [(p.graph, p.C_prev, p.touched) for p in plans]
    sums = []
    for width in (1, 4):
        sink, hub = InMemorySink(), Telemetry()
        hub.register(sink)
        eng = BatchedLouvainEngine(device="cpu", sub_batch=width,
                                   options=DENSE, telemetry=hub)
        res = eng.update_batch(items)
        assert eng.last_update_info.route == ("loop", "tile")[width > 1]
        got = {n: v for (n, _), v in sink.counters.items()
               if n in ("local_move_sweeps", "affected_vertices",
                        "split_moves")}
        assert got["local_move_sweeps"] == sum(r.iterations for r in res)
        assert got["affected_vertices"] == sum(r.n_affected for r in res)
        sums.append(got)
    assert sums[0] == sums[1] and len(sums[0]) == 3


def test_warm_updates_dispatch_one_full_filler_tile():
    eng = BatchedLouvainEngine(device="cpu", sub_batch=4, options=DENSE)
    b = Bucket(64, 512)
    assert eng.warm_updates(b) == 1
    info = eng.last_update_info
    assert (info.route, info.n, info.capacity) == ("tile", 4, 4)
    assert eng.warm_updates(b) == 0
    g, C, t = eng._filler_update(b)
    lone = td.warm_update(g, torch.from_numpy(C), torch.from_numpy(t),
                          scan="dense")
    r = eng.update_batch([eng._filler_update(b)] * 3)
    assert eng.last_update_info.compile_hit
    for x in r:
        np.testing.assert_array_equal(x.C, lone["C"].numpy())
        assert all(getattr(x, k) == lone[k] for k in KEYS)


def test_frontend_queued_updates_take_the_tile():
    """``CommunityService`` with ``update_batch_size=4`` and ``sub_batch=4``
    on the dense scan commits the entries of ``update_batch_size=1``."""
    graphs = [ego(s) for s in range(4)]
    rng = np.random.default_rng(3)
    upds = []
    for g in graphs:
        n = int(g.n_nodes)
        u, v = rng.integers(0, n, 5), rng.integers(0, n, 5)
        keep = u != v
        upds.append(GraphUpdate(u=u[keep], v=v[keep],
                                dw=np.ones(int(keep.sum()), np.float32),
                                add=1, remove=[int(rng.integers(0, n))]))

    def serve(update_batch_size):
        svc = sync_service(True, clock=FakeClock(), batch_size=4,
                           max_delay_s=10.0, sub_batch=4, detect=DENSE,
                           update_batch_size=update_batch_size)
        for i, g in enumerate(graphs):
            svc.submit_detect(f"g{i}", _port(g))
        svc.drain()
        for i, upd in enumerate(upds):
            svc.submit_update(f"g{i}", upd)
        svc.drain()
        return svc

    one, four = serve(1), serve(4)
    assert one.metrics.n_update_batches == 0
    assert four.metrics.n_update_batches >= 1
    assert four.engine.last_update_info.route == "tile"
    assert four.engine.last_update_info.n > 1
    for i in range(4):
        a, b = one.result(f"g{i}"), four.result(f"g{i}")
        np.testing.assert_array_equal(a.C, b.C)
        assert (a.q, a.n_communities, a.n_disconnected, a.version) == (
            b.q, b.n_communities, b.n_disconnected, b.version)
        assert a.version == 2 and b.n_disconnected == 0
        for k in ("src", "dst", "w", "n_nodes"):
            assert torch.equal(getattr(a.graph, k), getattr(b.graph, k))
