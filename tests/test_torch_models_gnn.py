"""The port's GNNs (``repro_torch.models.gnn``) against the JAX package on
the CPU: each smoke forward and its gradients with the reference's
parameters carried across, the dense GCN oracle, GAT's normalisation, the
Clebsch–Gordan tables bit for bit, and NequIP's invariances (the
reference's ``tests/test_models_gnn.py``).

Tolerances, float32: outputs within ``OUT_TOL`` (rtol = atol; the
scatter sums fold in other orders than XLA's), gradients within
``GRAD_RTOL``/``GRAD_ATOL``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

import repro.models.gnn as JG
import repro_torch.models.gnn as TG
from repro.configs import get_spec as j_spec
from repro.graph import sbm_graph
from repro.models.gnn import irreps as j_irreps
from repro_torch.configs import get_spec as t_spec
from repro_torch.launch.train import value_and_grad
from repro_torch.models import params_from_numpy
from repro_torch.models.gnn import common
from repro_torch.models.gnn.irreps import (
    _rotation, admissible_paths, clebsch_gordan, wigner_d,
)

OUT_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
GNN = ["gcn-cora", "gat-cora", "gatedgcn", "nequip"]


@pytest.fixture(scope="module")
def small_graph():
    return sbm_graph(n_nodes=50, n_blocks=3, p_in=0.4, p_out=0.05, seed=0)[0]


def _t(a):
    return torch.from_numpy(np.array(a))


def _models(arch, g, seed=0):
    """``(jax loss-free forward, torch forward, jax params, torch params,
    cfg pair)`` for ``arch``'s smoke config on ``g``."""
    jc, tc = j_spec(arch).smoke, t_spec(arch).smoke
    key = jax.random.PRNGKey(seed)
    rng = np.random.default_rng(seed)
    src, dst, w = np.asarray(g.src), np.asarray(g.dst), np.asarray(g.w)
    if arch == "nequip":
        jp = JG.init_nequip(key, jc)
        species = rng.integers(0, jc.n_species, g.nv).astype(np.int32)
        pos = rng.normal(size=(g.nv, 3)).astype(np.float32)

        def jf(p):
            return JG.nequip_forward(p, jnp.asarray(species), jnp.asarray(pos),
                                     g.src, g.dst, jc)

        def tf(p):
            return TG.nequip_forward(p, _t(species), _t(pos), _t(src),
                                     _t(dst), tc)
    else:
        x = (rng.normal(size=(g.nv, jc.d_in)) * 0.5).astype(np.float32)
        init = {"gcn-cora": JG.init_gcn, "gat-cora": JG.init_gat,
                "gatedgcn": JG.init_gatedgcn}[arch]
        jp = init(key, jc)
        if arch == "gcn-cora":
            def jf(p):
                return JG.gcn_forward(p, jnp.asarray(x), g.src, g.dst, jc)

            def tf(p):
                return TG.gcn_forward(p, _t(x), _t(src), _t(dst), tc)
        elif arch == "gat-cora":
            def jf(p):
                return JG.gat_forward(p, jnp.asarray(x), g.src, g.dst, jc)

            def tf(p):
                return TG.gat_forward(p, _t(x), _t(src), _t(dst), tc)
        else:
            def jf(p):
                return JG.gatedgcn_forward(p, jnp.asarray(x), g.src, g.dst,
                                           g.w, jc)

            def tf(p):
                return TG.gatedgcn_forward(p, _t(x), _t(src), _t(dst), _t(w),
                                           tc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jf, tf, jp, tp


@pytest.mark.parametrize("arch", GNN)
def test_forward_and_grads_match_reference(arch, small_graph):
    """The smoke forward, and the gradient of a weighted sum of its
    output, against the reference on the same parameters and inputs."""
    g = small_graph
    jf, tf, jp, tp = _models(arch, g)
    want = np.asarray(jax.jit(jf)(jp))
    with torch.no_grad():
        got = tf(tp).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    cot = np.random.default_rng(1).normal(size=want.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jf(p) * cot)))(jp)
    _, tg = value_and_grad(lambda p: torch.sum(tf(p) * _t(cot)), tp)
    tl = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), tg))
    jl = jax.tree.leaves(jg)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("arch", GNN)
def test_init_tree_matches_reference(arch):
    """``init_*`` draws the reference's tree: keys, nesting, shapes,
    float32."""
    jc, tc = j_spec(arch).smoke, t_spec(arch).smoke
    name = {"gcn-cora": "gcn", "gat-cora": "gat", "gatedgcn": "gatedgcn",
            "nequip": "nequip"}[arch]
    jp = getattr(JG, f"init_{name}")(jax.random.PRNGKey(0), jc)
    tp = getattr(TG, f"init_{name}")(torch.Generator().manual_seed(0), tc)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, tp))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == torch.float32


def test_gcn_matches_dense_oracle(small_graph):
    """GCN forward == dense Ahat @ X @ W reference."""
    g = small_graph
    n = int(g.n_nodes)
    cfg = TG.GCNConfig(d_in=8, d_hidden=6, n_classes=3, n_layers=2,
                       norm="sym")
    gen = torch.Generator().manual_seed(0)
    params = TG.init_gcn(gen, cfg)
    x = torch.randn((g.nv, 8), generator=gen)
    src, dst, w = (np.asarray(a) for a in (g.src, g.dst, g.w))
    with torch.no_grad():
        out = TG.gcn_forward(params, x, _t(src), _t(dst), cfg).numpy()[:n]

    A = np.zeros((n, n), np.float32)
    mask = src < g.n_cap
    for u, v, ww in zip(src[mask], dst[mask], w[mask]):
        A[v, u] += ww                       # in-neighbor aggregation
    Ah = A + np.eye(n)
    deg = np.asarray(g.degrees())[:n] + 1.0
    D = np.diag(deg ** -0.5)
    Ah = D @ Ah @ D
    h = x.numpy()[:n]
    for li, (wt, b) in enumerate(zip(params["w"], params["b"])):
        h = h @ wt.numpy() + b.numpy()
        h = Ah @ h
        if li < len(params["w"]) - 1:
            h = np.maximum(h, 0)
    np.testing.assert_allclose(out, h, rtol=1e-4, atol=1e-4)


def test_gcn_mean_norm_matches_reference(small_graph):
    g = small_graph
    cfg_j = JG.GCNConfig(d_in=8, d_hidden=6, n_classes=3, norm="mean")
    cfg_t = TG.GCNConfig(d_in=8, d_hidden=6, n_classes=3, norm="mean")
    jp = JG.init_gcn(jax.random.PRNGKey(3), cfg_j)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(3).normal(size=(g.nv, 8)).astype(np.float32)
    want = np.asarray(JG.gcn_forward(jp, jnp.asarray(x), g.src, g.dst, cfg_j))
    with torch.no_grad():
        got = TG.gcn_forward(tp, _t(x), _t(g.src), _t(g.dst), cfg_t).numpy()
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)


def test_gat_attention_normalized(small_graph):
    g = small_graph
    scores = torch.from_numpy(np.random.default_rng(0).normal(size=g.m_cap)
                              .astype(np.float32))
    src, dst = _t(g.src), _t(g.dst)
    mask = src < g.n_cap
    alpha = common.edge_softmax(scores, dst, g.nv, mask)
    sums = common.scatter_sum(alpha, dst, g.nv).numpy()
    deg = np.asarray(g.degrees())
    nonzero = deg[: int(g.n_nodes)] > 0
    np.testing.assert_allclose(sums[: int(g.n_nodes)][nonzero], 1.0,
                               rtol=1e-5)


@pytest.mark.parametrize("arch", ["gcn-cora", "gat-cora", "gatedgcn"])
def test_smoke_forward_all(arch, small_graph):
    g = small_graph
    cfg = t_spec(arch).smoke
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((g.nv, cfg.d_in), generator=gen)
    src, dst, w = _t(g.src), _t(g.dst), _t(g.w)
    if arch.startswith("gcn"):
        out = TG.gcn_forward(TG.init_gcn(gen, cfg), x, src, dst, cfg)
    elif arch == "gatedgcn":
        out = TG.gatedgcn_forward(TG.init_gatedgcn(gen, cfg), x, src, dst, w,
                                  cfg)
    else:
        out = TG.gat_forward(TG.init_gat(gen, cfg), x, src, dst, cfg)
    assert out.shape == (g.nv, cfg.n_classes)
    assert bool(torch.isfinite(out).all())


# --- NequIP / irreps -------------------------------------------------------

def test_cg_tables_bitwise_equal_reference():
    """Every admissible path's table, built in float64 by the reference's
    steps, equals the reference's bit for bit; so do the Wigner
    matrices."""
    assert admissible_paths(2) == j_irreps.admissible_paths(2)
    for p in admissible_paths(2):
        a, b = clebsch_gordan(*p), j_irreps.clebsch_gordan(*p)
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    R = _rotation(np.random.default_rng(3))
    np.testing.assert_array_equal(R, j_irreps._rotation(
        np.random.default_rng(3)))
    for l in range(3):  # noqa: E741
        np.testing.assert_array_equal(wigner_d(R, l), j_irreps.wigner_d(R, l))


def test_sh_matches_reference():
    x = np.random.default_rng(4).normal(size=(20, 3)).astype(np.float32)
    for l in range(3):  # noqa: E741
        np.testing.assert_allclose(
            TG.nequip.sh(_t(x), l).numpy(),
            np.asarray(j_irreps.sh(jnp.asarray(x), l)), rtol=1e-6, atol=1e-6)


def test_cg_paths_equivariant():
    rng = np.random.default_rng(7)
    for (l1, l2, l3) in admissible_paths(2):
        T = clebsch_gordan(l1, l2, l3)
        R = _rotation(rng)
        D1, D2, D3 = (wigner_d(R, l) for l in (l1, l2, l3))  # noqa: E741
        a = rng.normal(size=(2 * l1 + 1,))
        b = rng.normal(size=(2 * l2 + 1,))
        lhs = np.einsum("i,j,ijk->k", D1 @ a, D2 @ b, T)
        rhs = D3 @ np.einsum("i,j,ijk->k", a, b, T)
        np.testing.assert_allclose(lhs, rhs, atol=1e-10)


def test_cg_111_is_cross_product():
    T = clebsch_gordan(1, 1, 1)
    assert np.abs(T + T.transpose(1, 0, 2)).max() < 1e-8


def _nequip_inputs(nv, M, seed):
    rng = np.random.default_rng(seed)
    species = torch.from_numpy(rng.integers(0, 16, nv).astype(np.int32))
    pos = torch.from_numpy(rng.normal(size=(nv, 3)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, nv - 1, M).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, nv - 1, M).astype(np.int32))
    return rng, species, pos, src, dst


def test_nequip_energy_invariant_forces_equivariant():
    cfg = TG.NequIPConfig(n_layers=2, d_hidden=8, n_rbf=4)
    p = TG.init_nequip(torch.Generator().manual_seed(0), cfg)
    rng, species, pos, src, dst = _nequip_inputs(14, 48, 1)
    pos = pos * 2
    R = torch.from_numpy(_rotation(rng)).float()

    def energy_and_forces(x):
        x = x.clone().requires_grad_()
        e = torch.sum(TG.nequip_forward(p, species, x, src, dst, cfg))
        return e.detach(), torch.autograd.grad(e, x)[0]

    e1, f1 = energy_and_forces(pos)
    e2, f2 = energy_and_forces(pos @ R.T)
    assert float((e1 - e2).abs()) < 1e-4
    # forces rotate with the frame: F(Rx) == F(x) @ R^T (the reference
    # test's tolerances)
    np.testing.assert_allclose(f2.numpy(), (f1 @ R.T).numpy(), rtol=1e-3,
                               atol=3e-4)


def test_nequip_translation_invariant():
    cfg = TG.NequIPConfig(n_layers=2, d_hidden=8, n_rbf=4)
    p = TG.init_nequip(torch.Generator().manual_seed(0), cfg)
    _, species, pos, src, dst = _nequip_inputs(10, 30, 2)
    with torch.no_grad():
        e1 = TG.nequip_forward(p, species, pos, src, dst, cfg)
        e2 = TG.nequip_forward(p, species, pos + 5.0, src, dst, cfg)
    np.testing.assert_allclose(e1.numpy(), e2.numpy(), rtol=1e-4, atol=1e-5)
