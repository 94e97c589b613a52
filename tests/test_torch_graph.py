"""Graph substrate of the PyTorch port held against the JAX package.

The generators are numpy and copied verbatim, so the same seed must give
byte-identical arrays; the container must keep the reference's invariants;
``graph_from_arrays`` must carry a JAX-package graph across unchanged.
Everything runs on the CPU (``device="cpu"``).
"""
import numpy as np
import pytest
import torch

import repro.graph as rg
import repro_torch.graph as tg
from repro_torch.graph import container as tcont

FAMILIES = {
    "sbm": (lambda m, **kw: m.sbm_graph(96, 5, 0.4, 0.02, seed=2, **kw)[0]),
    "rmat": (lambda m, **kw: m.rmat_graph(scale=8, edge_factor=6, seed=1,
                                          **kw)),
    "ring_of_cliques": (lambda m, **kw: m.ring_of_cliques(12, 5, **kw)),
    "bridge": (lambda m, **kw: m.bridge_graph(**kw)[0]),
    "grid": (lambda m, **kw: m.grid_graph(10, 10, **kw)),
    "random_regular": (lambda m, **kw: m.random_regular_graph(128, 6, seed=3,
                                                              **kw)),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_graph(gt, gj):
    assert (gt.n_cap, gt.m_cap) == (gj.n_cap, gj.m_cap)
    for name in ("src", "dst", "w", "n_nodes"):
        a, b = _np(getattr(gt, name)), _np(getattr(gj, name))
        assert a.dtype == b.dtype, name
        assert a.tobytes() == b.tobytes(), f"{name} differs"


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_generators_byte_identical(family):
    make = FAMILIES[family]
    _assert_same_graph(make(tg, device="cpu"), make(rg))


@pytest.mark.parametrize("caps", [None, (300, 4000)])
def test_generators_byte_identical_padded(caps):
    kw = {} if caps is None else dict(n_cap=caps[0], m_cap=caps[1])
    gt, lt = tg.sbm_graph(200, 4, 0.2, 0.01, seed=5, device="cpu", **kw)
    gj, lj = rg.sbm_graph(200, 4, 0.2, 0.01, seed=5, **kw)
    _assert_same_graph(gt, gj)
    assert np.array_equal(lt, lj)
    assert tg.bridge_graph(device="cpu")[1] == rg.bridge_graph()[1]


def test_from_undirected_invariants():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 40, 150)
    v = rng.integers(0, 40, 150)
    w = rng.integers(1, 5, 150).astype(np.float32)
    g = tg.from_undirected(40, u, v, w, n_cap=48, m_cap=400, device="cpu")
    src, dst, ww = g.src.numpy(), g.dst.numpy(), g.w.numpy()
    assert src.dtype == np.int32 and ww.dtype == np.float32
    live = src < g.n_cap
    # sorted by (src, dst), padding at the tail on the ghost with w = 0
    assert np.all(np.lexsort((dst, src)) == np.arange(src.size))
    assert np.all(src[~live] == g.ghost) and np.all(dst[~live] == g.ghost)
    assert np.all(ww[~live] == 0) and np.all(live[: live.sum()])
    # both directions of every non-loop edge, self-loops once
    pairs = {(a, b): x for a, b, x in zip(src[live], dst[live], ww[live])}
    for (a, b), x in pairs.items():
        assert pairs[(b, a)] == x
    assert len(pairs) == live.sum()
    # K sums to 2m, the ghost gets 0
    K = g.vertex_weights()
    assert K.shape == (g.nv,) and float(K[g.ghost]) == 0.0
    assert float(K.sum()) == float(g.total_weight_2m())
    assert g.node_mask().sum() == 40 and g.edge_mask().sum() == live.sum()


def test_from_coo_matches_reference_and_validates():
    rng = np.random.default_rng(1)
    s = rng.integers(0, 30, 90)
    d = rng.integers(0, 30, 90)
    gt = tg.from_coo(30, s, d, n_cap=32, m_cap=100, device="cpu")
    gj = rg.from_coo(30, s, d, n_cap=32, m_cap=100)
    _assert_same_graph(gt, gj)
    np.testing.assert_array_equal(
        gt.vertex_weights().numpy(), np.asarray(gj.vertex_weights()))
    np.testing.assert_array_equal(gt.node_mask().numpy(),
                                  np.asarray(gj.node_mask()))
    with pytest.raises(ValueError):
        tg.from_coo(30, s, d, m_cap=10, device="cpu")
    with pytest.raises(ValueError):
        tg.from_coo(30, s, d, n_cap=20, device="cpu")


@pytest.mark.parametrize("family", ["rmat", "bridge"])
def test_graph_from_arrays_round_trip(family):
    gj = FAMILIES[family](rg)
    C = np.arange(gj.nv, dtype=np.int32)[::-1].copy()
    gt, Ct = tg.graph_from_arrays(np.asarray(gj.src), np.asarray(gj.dst),
                                  np.asarray(gj.w), int(gj.n_nodes),
                                  gj.n_cap, C=C, device="cpu")
    _assert_same_graph(gt, gj)
    assert Ct.dtype == torch.int32 and np.array_equal(Ct.numpy(), C)
    again = tg.graph_from_arrays(gt.src.numpy(), gt.dst.numpy(),
                                 gt.w.numpy(), int(gt.n_nodes), gt.n_cap,
                                 device="cpu")
    _assert_same_graph(again, gj)


def test_graph_from_arrays_rejects_broken_invariants():
    gj = rg.ring_of_cliques(4, 3)
    src, dst, w = (np.asarray(gj.src), np.asarray(gj.dst), np.asarray(gj.w))
    with pytest.raises(ValueError):
        tg.graph_from_arrays(src[::-1], dst, w, 12, gj.n_cap, device="cpu")
    with pytest.raises(ValueError):
        tg.graph_from_arrays(src, dst[:-1], w, 12, gj.n_cap, device="cpu")
    with pytest.raises(ValueError):
        tg.graph_from_arrays(src, dst, w, 12, gj.n_cap - 2, device="cpu")
    with pytest.raises(ValueError):
        tg.graph_from_arrays(src, dst, w, 12, gj.n_cap,
                             C=np.zeros(3, np.int32), device="cpu")


def test_graph_to_device_is_identity_on_same_device():
    g = tg.grid_graph(3, 3, device="cpu")
    assert g.to("cpu") is g and g.device == torch.device("cpu")


def test_constructors_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.grid_graph(3, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcont.from_coo(2, [0, 1], [1, 0])
    gj = rg.grid_graph(2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.graph_from_arrays(np.asarray(gj.src), np.asarray(gj.dst),
                             np.asarray(gj.w), 4, gj.n_cap)
