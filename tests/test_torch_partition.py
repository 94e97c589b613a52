"""The port's vertex-aligned partition (``repro_torch.graph.partition``)
held against the JAX package's ``repro.graph.partition`` on the CPU:
every array byte for byte on ring, SBM, grid and R-MAT graphs at 1 to 5
shards, the vertex roles, the rejections with the reference's messages,
and the reassemble round trip (a property, as the reference's)."""
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import _port

import repro.graph as rg
import repro.graph.partition as jpart
import repro_torch.graph.partition as tpart
from tests._hypothesis_compat import given, settings, st

FAMILIES = {
    "ring": lambda: rg.ring_of_cliques(n_cliques=12, clique_size=6),
    "sbm": lambda: rg.sbm_graph(n_nodes=200, n_blocks=5, p_in=0.4,
                                p_out=0.02, seed=3)[0],
    "grid": lambda: rg.grid_graph(12, 12),
    "rmat": lambda: rg.rmat_graph(scale=9, edge_factor=8, seed=11),
    "padded sbm": lambda: rg.sbm_graph(n_nodes=120, n_blocks=4, p_in=0.3,
                                       p_out=0.02, seed=5, n_cap=140,
                                       m_cap=4000)[0],
}


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_partition_equals_reference(family, n_shards):
    gj = FAMILIES[family]()
    want = jpart.partition_edges_by_src(gj, n_shards)
    got = tpart.partition_edges_by_src(_port(gj), n_shards)
    assert sorted(got) == sorted(want)
    for k in want:
        _same(got[k], want[k], k)
    for s in range(n_shards):
        rt, rj = (tpart.shard_vertex_roles(got, s),
                  jpart.shard_vertex_roles(want, s))
        assert sorted(rt) == sorted(rj)
        for k in rj:
            _same(rt[k], rj[k], f"shard {s} {k}")


def test_edge_ranges_are_the_partition():
    gj = FAMILIES["rmat"]()
    parts = jpart.partition_edges_by_src(gj, 4)
    src = np.asarray(gj.src)
    bounds, ranges = tpart.shard_edge_ranges(src[src < gj.n_cap], gj.nv, 4)
    _same(bounds[:-1].astype(np.int32), parts["v_lo"], "v_lo")
    _same(bounds[1:].astype(np.int32), parts["v_hi"], "v_hi")
    assert [e1 - e0 for e0, e1 in ranges] == list(parts["m_valid"])
    assert ranges[0][0] == 0 and ranges[-1][1] == int(parts["m_valid"].sum())


def test_rejections_carry_the_reference_messages():
    gj = rg.ring_of_cliques(n_cliques=4, clique_size=4)
    tg = _port(gj)
    for part, g in ((jpart, gj), (tpart, tg)):
        with pytest.raises(ValueError, match=r"^n_shards must be >= 1, got 0$"):
            part.partition_edges_by_src(g, 0)
    shuffled = np.asarray(gj.src).copy()
    shuffled[:8] = shuffled[:8][::-1]
    assert shuffled[0] != shuffled[7]
    bad_j = type(gj)(src=shuffled, dst=gj.dst, w=gj.w, n_nodes=gj.n_nodes,
                     n_cap=gj.n_cap, m_cap=gj.m_cap)
    bad_t = type(tg)(src=torch.from_numpy(shuffled), dst=tg.dst, w=tg.w,
                     n_nodes=tg.n_nodes, n_cap=tg.n_cap, m_cap=tg.m_cap)
    msg = r"^edges not sorted by src: container invariant broken$"
    for part, g in ((jpart, bad_j), (tpart, bad_t)):
        with pytest.raises(ValueError, match=msg):
            part.partition_edges_by_src(g, 2)


def test_shard_graph_gives_tensors_on_the_graph_device():
    tg = _port(FAMILIES["grid"]())
    shards = tpart.shard_graph(tg, 3)
    parts = tpart.partition_edges_by_src(tg, 3)
    assert sorted(shards) == sorted(parts)
    for k, v in shards.items():
        assert isinstance(v, torch.Tensor) and v.device == tg.device
        _same(v.numpy(), parts[k], k)


@settings(max_examples=25, deadline=None)
@given(st.integers(min_value=12, max_value=80),
       st.integers(min_value=1, max_value=6),
       st.integers(min_value=0, max_value=2 ** 31 - 1))
def test_partition_round_trip_property(n, s, seed):
    """For any SBM graph and shard count, partitioning and reassembling
    gives the live directed edge list byte for byte (mirrors the
    reference's property)."""
    gj, _ = rg.sbm_graph(n_nodes=n, n_blocks=max(2, n // 10), p_in=0.3,
                         p_out=0.05, seed=seed)
    tg = _port(gj)
    live = int((tg.src < tg.n_cap).sum())
    parts = tpart.partition_edges_by_src(tg, s)
    src, dst, w = tpart.reassemble_edges(parts)
    _same(src, tg.src[:live].numpy(), "src")
    _same(dst, tg.dst[:live].numpy(), "dst")
    _same(w, tg.w[:live].numpy(), "w")
    assert int(parts["m_valid"].sum()) == live
