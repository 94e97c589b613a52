"""The port's unfused sweep (``seg_impl='scatter'``,
``core/local_move.py:_half_sweep_scatter``) held bit for bit against the
port's fused ``_half_sweep`` and against the reference's
``_half_sweep_scatter``, on the CPU: one half-sweep on seeded random
states (``tests/test_seg_backend.py``'s inputs and the four tier-1 graphs
of that file, a padded graph), then ``local_move`` and
``warm_local_move`` with ``seg_impl='scatter'`` against ``'auto'`` and
against the reference's scatter runs.

The one exception is the half-sweep's ``gain`` against the reference: a
flat float32 sum that neither package feeds to a decision (the reference's
``jnp.sum``, the port's ``torch.sum``, as in ``test_torch_detect.py``); it
is held within 1e-6 there and bit for bit between the port's two sweeps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import _eq, _port, _t

import repro.core as jcore
import repro.graph as rg
from repro.core import dynamic as jd
from repro.core.local_move import _half_sweep_scatter as j_scatter
from repro.core.local_move import local_move as j_local_move
from repro_torch.core import dynamic as td
from repro_torch.core.local_move import _half_sweep as t_fused
from repro_torch.core.local_move import _half_sweep_scatter as t_scatter
from repro_torch.core.local_move import local_move as t_local_move

NAMES = ("C", "Sigma", "moved", "gain", "want")

GRAPHS = {
    # tests/test_seg_backend.py's fused-vs-scatter graph and its four
    # tier-1 graphs
    "rmat8": lambda: rg.rmat_graph(scale=8, edge_factor=6, seed=4),
    "kmer_ring": lambda: rg.ring_of_cliques(12, 5),
    "road_grid": lambda: rg.grid_graph(10, 10),
    "soc_sbm": lambda: rg.sbm_graph(n_nodes=96, n_blocks=5, p_in=0.4,
                                    p_out=0.02, seed=2)[0],
    "web_rmat": lambda: rg.rmat_graph(scale=8, edge_factor=6, seed=1),
    # ghost padding in both capacities
    "padded": lambda: rg.sbm_graph(n_nodes=90, n_blocks=4, p_in=0.3,
                                   p_out=0.03, seed=6, n_cap=128,
                                   m_cap=4096)[0],
}
# (target_ok given, anchored): handshake, parity, all
SCHEDULES = [(True, True), (False, True), (False, False)]


def _inputs(gj, seed):
    """A seeded random state of ``tests/test_seg_backend.py:121``: labels,
    K and Sigma by the reference's segment sums, movable and target
    masks."""
    nv = gj.nv
    rng = np.random.default_rng(seed)
    C = rng.integers(0, nv - 1, nv).astype(np.int32)
    C[nv - 1] = nv - 1
    K = np.asarray(jax.ops.segment_sum(gj.w, gj.src, num_segments=nv))
    Sigma = np.asarray(jax.ops.segment_sum(jnp.asarray(K), jnp.asarray(C),
                                           num_segments=nv))
    return C, K, Sigma, rng.random(nv) < 0.5, rng.random(nv) < 0.5


@pytest.mark.parametrize("target,anchored", SCHEDULES,
                         ids=["handshake", "parity", "all"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_scatter_sweep_bitwise_equals_fused_and_reference(graph, target,
                                                          anchored):
    gj = GRAPHS[graph]()
    C, K, Sigma, movable, target_ok = _inputs(gj, 5)
    jt = jnp.asarray(target_ok) if target else None
    want = j_scatter(gj.src, gj.dst, gj.w, jnp.asarray(C), jnp.asarray(K),
                     jnp.asarray(Sigma), jnp.sum(gj.w), jnp.ones(gj.nv, bool),
                     jnp.asarray(movable), None, target_ok=jt,
                     anchored=anchored)
    tg = _port(gj)
    args = (tg.src, tg.dst, tg.w, _t(C), _t(K), _t(Sigma),
            tg.total_weight_2m(), _t(movable))
    kw = dict(target_ok=_t(target_ok) if target else None,
              anchored=anchored)
    got = t_scatter(*args, **kw)
    fused = t_fused(*args, **kw)
    assert float(tg.total_weight_2m()) == float(jnp.sum(gj.w))
    for name, a, f, b in zip(NAMES, got, fused, want):
        assert torch.equal(a, f), f"{name}: scatter != fused"
        if name == "gain":   # a flat float32 sum that decides nothing
            assert abs(float(a) - float(b)) <= 1e-6 * max(1.0, abs(float(b)))
        else:
            _eq(a, b, name)
    assert bool(got[2].any()), "no vertex moved: a vacuous case"


@pytest.mark.parametrize("sync", ["handshake", "parity", "all"])
@pytest.mark.parametrize("graph", ["rmat8", "soc_sbm", "padded"])
def test_local_move_scatter_equals_auto_and_reference(graph, sync):
    gj = GRAPHS[graph]()
    tg = _port(gj)
    K = jax.ops.segment_sum(gj.w, gj.src, num_segments=gj.nv)
    C0 = jnp.arange(gj.nv, dtype=jnp.int32)
    Cj, Sj, lij = j_local_move(gj.src, gj.dst, gj.w, C0, K, K,
                                jnp.sum(gj.w), tau=jnp.float32(1e-2),
                                sync=sync, seg_impl="scatter")
    Kt = tg.vertex_weights()
    out = {impl: t_local_move(tg.src, tg.dst, tg.w, _t(C0), Kt, Kt,
                              tg.total_weight_2m(), tau=np.float32(1e-2),
                              sync=sync, seg_impl=impl)
           for impl in ("auto", "scatter")}
    (Cs, Ss, lis), (Ca, Sa, lia) = out["scatter"], out["auto"]
    assert torch.equal(Cs, Ca) and torch.equal(Ss, Sa) and lis == lia
    _eq(Cs, Cj, "C")
    _eq(Ss, Sj, "Sigma")
    assert lis == int(lij)


@pytest.mark.parametrize("scan", ["sort", "dense"])
def test_warm_local_move_both_seg_impls(scan):
    """The warm start with ``seg_impl='scatter'`` and ``'auto'`` against
    the reference's ``warm_local_move`` with ``'scatter'`` (the dense
    scan ignores ``seg_impl`` in both packages)."""
    gj, _ = rg.sbm_graph(n_nodes=240, n_blocks=6, p_in=0.35, p_out=0.01,
                         seed=2, m_cap=2 * 9000)
    C = np.asarray(jcore.louvain(gj, jcore.LouvainConfig())[0])
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, 240, 30), rng.integers(0, 240, 30)
    g2 = jd.apply_edge_updates(gj, *jd.directed_deltas(
        u, v, np.ones(30, np.float32)))
    t = jd.touched_mask(g2.nv, u, v)
    active0 = jd.affected_mask(g2, jnp.asarray(C), jnp.asarray(t))
    Cj, Sj, itj = jd.warm_local_move(
        jnp.asarray(g2.src), jnp.asarray(g2.dst), jnp.asarray(g2.w),
        jnp.asarray(C), jnp.sum(jnp.asarray(g2.w)), active0, scan=scan,
        seg_impl="scatter")
    tg = _port(g2)
    for impl in ("auto", "scatter"):
        Ct, St, itt = td.warm_local_move(
            tg.src, tg.dst, tg.w, _t(C), tg.total_weight_2m(),
            _t(np.asarray(active0)), scan=scan, seg_impl=impl)
        _eq(Ct, Cj, f"C ({impl})")
        _eq(St, Sj, f"Sigma ({impl})")
        assert itt == int(itj)


def test_scatter_sweep_takes_unsorted_edges():
    """Like the reference's, the scatter sweep (and its dst-keyed wake-up)
    needs no sorted ``src``: a shuffled edge order gives the sorted
    order's labels and Sigma."""
    gj = GRAPHS["soc_sbm"]()
    tg = _port(gj)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(gj.m_cap))
    Kt = tg.vertex_weights()
    ids = torch.arange(tg.nv, dtype=torch.int32)
    kw = dict(tau=np.float32(1e-2), seg_impl="scatter")
    Cs, Ss, lis = t_local_move(tg.src, tg.dst, tg.w, ids, Kt, Kt,
                               tg.total_weight_2m(), **kw)
    Cu, Su, liu = t_local_move(tg.src[perm], tg.dst[perm], tg.w[perm], ids,
                               Kt, Kt, tg.total_weight_2m(), **kw)
    assert torch.equal(Cs, Cu) and torch.equal(Ss, Su) and lis == liu


@pytest.mark.parametrize("impl", ["xla", "pallas", "bogus"])
def test_unported_seg_impls_raise(impl):
    tg = _port(GRAPHS["road_grid"]())
    Kt = tg.vertex_weights()
    ids = torch.arange(tg.nv, dtype=torch.int32)
    with pytest.raises(ValueError, match="seg_impl"):
        t_local_move(tg.src, tg.dst, tg.w, ids, Kt, Kt,
                     tg.total_weight_2m(), tau=np.float32(1e-2),
                     seg_impl=impl)
    with pytest.raises(ValueError, match="seg_impl"):
        td.warm_local_move(tg.src, tg.dst, tg.w, ids, tg.total_weight_2m(),
                           torch.ones(tg.nv, dtype=torch.bool),
                           seg_impl=impl)
