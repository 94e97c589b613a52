"""The port's neighbour sampler (``repro_torch.graph.sampler``) against the
JAX package on the CPU: given the reference's own draws, the sampled
neighbours and masks equal the reference's bit for bit; static shapes,
sampled edges exist, and one generator seed gives one sample (the
reference's ``tests/test_sampler.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

from repro.graph import sbm_graph
from repro.graph.sampler import neighbor_sample as j_neighbor_sample
from repro_torch.graph import graph_from_arrays
from repro_torch.graph.sampler import (
    DRAW_HIGH, neighbor_sample, sample_layer, subgraph_relabel,
)


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference_draws(key, frontier_sizes, fanouts):
    """The draws ``repro.graph.sampler.neighbor_sample`` makes: one
    ``randint`` a layer from the next split of ``key``."""
    draws = []
    for n, f in zip(frontier_sizes, fanouts):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.randint(
            sub, (n, f), 0, jnp.iinfo(jnp.int32).max, dtype=jnp.int32)))
    return draws


@pytest.mark.parametrize("fanouts", [(6,), (5, 3), (15, 10)])
@pytest.mark.parametrize("seed", [0, 1])
def test_neighbours_bitwise_equal_reference_given_its_draws(seed, fanouts):
    """Layer by layer, :func:`sample_layer` on the reference's draws gives
    the reference's sources, neighbours and masks bit for bit; isolated
    vertices (degree 0) and the ghost among the seeds take the self-edge
    fallback."""
    g = sbm_graph(120, 4, p_in=0.1, p_out=0.005, seed=seed, n_cap=128)[0]
    seeds = np.concatenate([np.arange(0, 120, 7), [120, 124, 128]]).astype(
        np.int32)           # 120..127 are isolated, 128 is the ghost
    key = jax.random.PRNGKey(seed)
    want = j_neighbor_sample(key, jnp.asarray(seeds), g.row_offsets(), g.dst,
                             fanouts)
    sizes = [len(seeds) * int(np.prod(fanouts[:i]))
             for i in range(len(fanouts))]
    draws = _reference_draws(key, sizes, fanouts)
    offs, dst = _t(g.row_offsets()), _t(g.dst)
    frontier = _t(seeds)
    for r, lay in zip(draws, want["layers"]):
        assert r.max() < DRAW_HIGH
        nbrs, valid = sample_layer(_t(r), frontier, offs, dst)
        np.testing.assert_array_equal(nbrs.reshape(-1).numpy(),
                                      np.asarray(lay["dst"]))
        np.testing.assert_array_equal(valid.reshape(-1).numpy(),
                                      np.asarray(lay["valid"]))
        np.testing.assert_array_equal(
            frontier.repeat_interleave(r.shape[1]).numpy(),
            np.asarray(lay["src"]))
        assert nbrs.dtype == torch.int32
        frontier = nbrs.reshape(-1)
    assert not np.asarray(want["layers"][0]["valid"]).all()


def test_row_offsets_match_reference():
    gj = sbm_graph(100, 4, seed=0)[0]
    g = graph_from_arrays(np.asarray(gj.src), np.asarray(gj.dst),
                          np.asarray(gj.w), int(gj.n_nodes), gj.n_cap,
                          device="cpu")
    np.testing.assert_array_equal(g.row_offsets().numpy(),
                                  np.asarray(gj.row_offsets()))


def test_shapes_static():
    g = sbm_graph(100, 4, seed=0)[0]
    seeds = torch.arange(8, dtype=torch.int32)
    out = neighbor_sample(torch.Generator().manual_seed(0), seeds,
                          _t(g.row_offsets()), _t(g.dst), (5, 3),
                          device="cpu")
    assert out["frontiers"][0].shape == (8,)
    assert out["frontiers"][1].shape == (40,)
    assert out["frontiers"][2].shape == (120,)
    assert out["layers"][0]["src"].shape == (40,)
    assert out["layers"][1]["src"].shape == (120,)
    nodes, offsets = subgraph_relabel(out["frontiers"])
    assert nodes.shape == (168,) and offsets == [0, 8, 48]


def test_sampled_edges_exist():
    g = sbm_graph(80, 4, seed=1)[0]
    dst = np.asarray(g.dst)
    src = np.asarray(g.src)
    adj = {}
    mask = src < g.n_cap
    for u, v in zip(src[mask], dst[mask]):
        adj.setdefault(int(u), set()).add(int(v))
    out = neighbor_sample(torch.Generator().manual_seed(1),
                          torch.arange(10, dtype=torch.int32),
                          _t(g.row_offsets()), _t(g.dst), (6,), device="cpu")
    lay = out["layers"][0]
    for u, v, ok in zip(lay["src"].numpy(), lay["dst"].numpy(),
                        lay["valid"].numpy()):
        if ok:
            assert int(v) in adj.get(int(u), set()), (u, v)
        else:
            assert u == v  # degree-0 fallback is a self edge


def test_deterministic_given_generator_seed():
    g = sbm_graph(60, 3, seed=2)[0]
    seeds = torch.arange(6, dtype=torch.int32)

    def run(s):
        return neighbor_sample(torch.Generator().manual_seed(s), seeds,
                               _t(g.row_offsets()), _t(g.dst), (4, 2),
                               device="cpu")

    a, b, c = run(7), run(7), run(8)
    for la, lb in zip(a["layers"], b["layers"]):
        assert torch.equal(la["dst"], lb["dst"])
    assert not torch.equal(a["layers"][1]["dst"], c["layers"][1]["dst"])
