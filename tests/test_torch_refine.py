"""Leiden-style refinement (``refine_labels``, max-quality's split slot) of
the PyTorch port, held against the JAX package's ``refine_labels`` on the
CPU, with the properties of the reference's ``tests/test_refine.py``:
padding-tail invariance, explicit zero-weight edges, the singleton fixed
point, the tau boundary, and a connected refinement over seeds.  Every
property is checked on the port's output, and the output is equal to the
reference's on the same inputs.  Refining a Louvain membership of the
R-MAT family also shows parts that the reference leaves unconnected; the
port leaves the same ones (``REFERENCE_SPLIT_PARTS``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import GRAPHS, _eq, _port, _t

import repro.core as jcore
import repro.graph as rg
from repro.core.louvain import refine_labels as j_refine
from repro_torch.core.louvain import refine_labels as t_refine

TAU = np.float32(1e-2)


def _refine_both(gj, C, tau=TAU, **kw):
    """The port's refinement (as numpy), after checking it equals the
    reference's on the same inputs."""
    C = np.asarray(C, np.int32)
    Rj = j_refine(gj.src, gj.dst, gj.w, jnp.asarray(C),
                  gj.total_weight_2m(), tau=tau, seg_impl="xla", **kw)
    tg = _port(gj)
    Rt = t_refine(tg.src, tg.dst, tg.w, _t(C), tg.total_weight_2m(),
                  tau=tau, **kw)
    _eq(Rt, Rj, "refined labels")
    return Rt.numpy()


def _is_refinement(C, R, n):
    """Every R-part maps into exactly one C-community."""
    C, R = np.asarray(C)[:n], np.asarray(R)[:n]
    for r in np.unique(R):
        assert len(np.unique(C[R == r])) == 1, f"part {r} spans communities"


def _split_parts(g, R, n):
    """The R-parts (as sorted member lists) that are not connected through
    their own internal (w > 0) edges."""
    src, dst, w = (np.asarray(a) for a in (g.src, g.dst, g.w))
    live = (src < g.n_cap) & (w > 0)
    R = np.asarray(R)
    split = []
    for r in np.unique(R[:n]):
        members = np.flatnonzero(R[:n] == r)
        inside = live & (R[src] == r) & (R[dst] == r)
        adj = {int(m): [] for m in members}
        for u, v in zip(src[inside], dst[inside]):
            adj[int(u)].append(int(v))
        seen, stack = {int(members[0])}, [int(members[0])]
        while stack:
            for nb in adj[stack.pop()]:
                if nb not in seen:
                    seen.add(nb)
                    stack.append(nb)
        if seen != set(int(m) for m in members):
            split.append(members.tolist())
    return split


def _parts_connected(g, R, n):
    """Every R-part is connected through its own internal (w > 0) edges."""
    assert _split_parts(g, R, n) == []


def _two_triangles(m_cap=None):
    """Two triangles bridged by one edge."""
    u = np.array([0, 1, 2, 3, 4, 5, 2])
    v = np.array([1, 2, 0, 4, 5, 3, 3])
    return rg.from_undirected(6, u, v, n_cap=8, m_cap=m_cap or 14)


# Parts that the reference's refine_labels leaves unconnected (ROADMAP
# C.7): vertices join a neighbour's community, whose founding vertex then
# moves on, in a later sweep, and takes with it the only path between
# them.  The port gives the same parts.
REFERENCE_SPLIT_PARTS = {
    ("rmat", 0.0): [[43, 109]],
    ("rmat", 1e6): [[321, 406], [209, 444], [78, 368]],
}


@pytest.mark.parametrize("tau", [1e-2, 0.0, 1e6], ids=["1e-2", "0", "1e6"])
@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_refine_labels_equal_reference(family, tau):
    """Refinement of a one-pass Louvain membership: a refinement of it,
    whose parts are connected except where the reference's are not."""
    gj = GRAPHS[family]()
    C, _ = jcore.louvain(gj, jcore.LouvainConfig(max_passes=1, split="none"))
    R = _refine_both(gj, C, tau=np.float32(tau))
    n = int(gj.n_nodes)
    _is_refinement(C, R, n)
    assert _split_parts(gj, R, n) == \
        REFERENCE_SPLIT_PARTS.get((family, tau), [])


def test_refine_invariant_to_padding_tail():
    g_tight, g_padded = _two_triangles(m_cap=14), _two_triangles(m_cap=64)
    R1 = _refine_both(g_tight, np.zeros(g_tight.nv, np.int32))
    R2 = _refine_both(g_padded, np.zeros(g_padded.nv, np.int32))
    assert np.array_equal(R1[:6], R2[:6])
    _is_refinement(np.zeros(6), R1, 6)
    _parts_connected(g_tight, R1, 6)
    # the bridge alone cannot hold one community: the triangles come back
    assert R1[0] == R1[1] == R1[2] and R1[3] == R1[4] == R1[5]
    assert R1[0] != R1[3]


def test_refine_ignores_explicit_zero_weight_edges():
    g = _two_triangles(m_cap=32)
    u = np.array([0, 1, 2, 3, 4, 5, 2, 0, 1])
    v = np.array([1, 2, 0, 4, 5, 3, 3, 4, 5])
    w = np.array([1, 1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    g_zero = rg.from_undirected(6, u, v, w, n_cap=8, m_cap=32)
    C = np.zeros(g.nv, np.int32)
    assert np.array_equal(_refine_both(g, C)[:6], _refine_both(g_zero, C)[:6])


def test_refine_all_singleton_input_is_fixed_point():
    g = rg.sbm_graph(n_nodes=24, n_blocks=3, p_in=0.5, p_out=0.05, seed=3)[0]
    C = np.arange(g.nv, dtype=np.int32)
    assert np.array_equal(_refine_both(g, C), C)


def test_refine_tau_boundary():
    g = _two_triangles()
    C = np.zeros(g.nv, np.int32)
    # above any gain, tau stops after the two-sweep warm-up: max_iters=2
    R_hi = _refine_both(g, C, tau=np.float32(1e6))
    R_two = _refine_both(g, C, tau=np.float32(0.0), max_iters=2)
    assert np.array_equal(R_hi[:6], R_two[:6])
    _is_refinement(C, R_hi, 6)
    _parts_connected(g, R_hi, 6)
    R_lo = _refine_both(g, C, tau=np.float32(0.0))
    _is_refinement(C, R_lo, 6)
    _parts_connected(g, R_lo, 6)
    assert len(np.unique(R_lo[:6])) == 2


@pytest.mark.parametrize("seed", range(12))
def test_refine_is_connected_refinement(seed):
    """Random weighted graphs and arbitrary (even disconnected) input
    communities, as the reference's property test draws them."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 28))
    m = int(rng.integers(n, 3 * n))
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = u != v
    w = rng.uniform(0.1, 2.0, int(keep.sum())).astype(np.float32)
    g = rg.from_undirected(n, u[keep], v[keep], w,
                           n_cap=n + int(rng.integers(0, 5)), m_cap=2 * m + 8)
    C = np.asarray(rng.integers(0, max(2, n // 3), g.nv), np.int32)
    R = _refine_both(g, C)
    _is_refinement(C, R, n)
    _parts_connected(g, R, n)
