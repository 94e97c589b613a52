"""The graph-event streams of the PyTorch port
(``repro_torch.data.streams``) held against the JAX package's
``repro.data.streams``, on the CPU.

The same seed must give the reference's events, field for field
(time, kind, endpoints, weight), and the reference's planted lifecycle
script and initial graph.  Mirrors ``test_graph_event_stream_*`` and
``test_planted_script_*`` of tests/test_timeline.py.
"""
import dataclasses
import itertools

import numpy as np
import pytest

import repro.data.streams as js
from repro.graph import ring_of_cliques as j_ring
from repro.graph import sbm_graph as j_sbm
import repro_torch.data as td
from repro_torch.data import (
    DEFAULT_CHURN_MIX, GraphEvent, graph_dataset, graph_event_stream,
    planted_timeline_script,
)
from repro_torch.graph import ring_of_cliques, sbm_graph


def _fields(events):
    return [dataclasses.astuple(e) for e in events]


def _take(stream, n):
    return list(itertools.islice(stream, n))


def _same_graph(a, b):
    for k in ("src", "dst", "w"):
        np.testing.assert_array_equal(getattr(a, k).numpy(),
                                      np.asarray(getattr(b, k)))
    assert int(a.n_nodes) == int(b.n_nodes)
    assert (a.n_cap, a.m_cap) == (b.n_cap, b.m_cap)


def test_graph_event_stream_is_deterministic_and_valid():
    g0 = ring_of_cliques(n_cliques=4, clique_size=5, device="cpu")
    a = _take(graph_event_stream(g0, rate=50.0, seed=13), 200)
    b = _take(graph_event_stream(g0, rate=50.0, seed=13), 200)
    assert a == b
    assert all(x.t <= y.t for x, y in zip(a, a[1:]))
    minted = [e.u for e in a if e.kind == "vertex_add"]
    assert len(minted) == len(set(minted))
    assert all(e.u >= int(g0.n_nodes) for e in a if e.kind == "vertex_add")
    ref = _take(js.graph_event_stream(
        j_ring(n_cliques=4, clique_size=5), rate=50.0, seed=13), 200)
    assert _fields(a) == _fields(ref)


MIXES = {
    "default": DEFAULT_CHURN_MIX,
    "removal-heavy": (("edge_add", 0.3), ("edge_del", 0.1),
                      ("vertex_add", 0.2), ("vertex_del", 0.4)),
    "edges-only": (("edge_add", 0.5), ("edge_del", 0.3),
                   ("edge_delta", 0.2)),
}


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("seed", [0, 7])
def test_graph_event_stream_equals_the_reference(mix, seed):
    """Every event of 400, under each mix, on an SBM with padding."""
    kw = dict(n_nodes=40, n_blocks=4, p_in=0.4, p_out=0.05, seed=seed,
              n_cap=64, m_cap=1024)
    gt, gj = sbm_graph(device="cpu", **kw)[0], j_sbm(**kw)[0]
    skw = dict(rate=20.0, seed=seed, mix=MIXES[mix], t0=1.5,
               min_vertices=12, wire_degree=2)
    a = _take(graph_event_stream(gt, **skw), 400)
    b = _take(js.graph_event_stream(gj, **skw), 400)
    assert _fields(a) == _fields(b)
    assert {e.kind for e in a} <= {k for k, _ in MIXES[mix]}
    assert DEFAULT_CHURN_MIX == js.DEFAULT_CHURN_MIX


def test_planted_script_shape_and_determinism():
    g0, windows, expected = planted_timeline_script(device="cpu")
    g0b, windows_b, _ = planted_timeline_script(device="cpu")
    assert windows == windows_b
    assert expected == [[], ["merge"], ["split"], ["death"], ["birth"]]
    assert len(windows) == 5 and windows[0] == []
    for i, evs in enumerate(windows):
        for e in evs:
            assert i * 1.0 < e.t < (i + 1) * 1.0
    with pytest.raises(ValueError):
        planted_timeline_script(clique=2, device="cpu")
    with pytest.raises(ValueError):
        planted_timeline_script(n_cliques=2, device="cpu")
    assert all(isinstance(e, GraphEvent) for w in windows for e in w)


@pytest.mark.parametrize("kw", [dict(), dict(clique=5, n_cliques=3,
                                             window=2.0)])
def test_planted_script_equals_the_reference(kw):
    gt, wt, et = planted_timeline_script(device="cpu", **kw)
    gj, wj, ej = js.planted_timeline_script(**kw)
    _same_graph(gt, gj)
    assert [_fields(w) for w in wt] == [_fields(w) for w in wj]
    assert et == ej


@pytest.mark.parametrize("name,kw", [
    ("sbm", dict(n_nodes=50, n_blocks=5, seed=2)),
    ("rmat", dict(scale=7, edge_factor=4, seed=1)),
    ("grid", dict(rows=5, cols=7)),
    ("ring", dict(n_cliques=5, clique_size=4)),
])
def test_graph_dataset_equals_the_reference(name, kw):
    _same_graph(graph_dataset(name, device="cpu", **kw),
                js.graph_dataset(name, **kw))


def test_graph_dataset_rejects_unknown_names():
    with pytest.raises(KeyError):
        graph_dataset("lfr", device="cpu")
    assert set(td.__all__) >= {"GraphEvent", "graph_event_stream",
                               "planted_timeline_script", "graph_dataset"}
