"""``detect(scan='dense')`` of the PyTorch port held against the JAX
package's ``scan='dense'`` and against the port's own ``scan='sort'``, on
the CPU, for every tier and every split policy on the six tier-1 families
and on a graph with padding vertices and edge slots.

Labels, stats and ``n_disconnected`` are compared exactly against both.
Between the port's two scans the modularity is compared bit for bit too;
against the reference within ``Q_ATOL`` (its flat float32 sums fold in
another order than ``jnp.sum``).
"""
import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import GRAPHS, Q_ATOL, _eq, _port
from test_torch_portfolio import RUNS

import repro.core as jcore
import repro.graph as rg
import repro_torch.core as tcore

FAMILIES = dict(GRAPHS, padded_rmat=lambda: rg.rmat_graph(
    scale=8, edge_factor=6, seed=2, n_cap=300, m_cap=4000))


def _detect_port(tg, algorithm, split, scan):
    return tcore.detect(tg, options=tcore.DetectOptions(
        algorithm=algorithm, scan=scan,
        louvain=tcore.LouvainConfig(split=split)), device="cpu")


@pytest.mark.parametrize("algorithm,split", RUNS,
                         ids=[f"{a}-{s}" for a, s in RUNS])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_detect_dense_equals_reference_and_sort(family, algorithm, split):
    gj = FAMILIES[family]()
    tg = _port(gj)
    dense = _detect_port(tg, algorithm, split, "dense")
    sort = _detect_port(tg, algorithm, split, "sort")
    ref = jcore.detect(gj, options=jcore.DetectOptions(
        algorithm=algorithm, scan="dense",
        louvain=jcore.LouvainConfig(split=split)))
    what = f"{family} {algorithm} {split}"
    _eq(dense.labels, ref.labels, f"{what} labels (vs repro)")
    _eq(dense.labels, sort.labels.numpy(), f"{what} labels (vs sort)")
    assert dense.stats == sort.stats == {k: int(v)
                                         for k, v in ref.stats.items()}
    assert dense.n_disconnected == sort.n_disconnected == int(
        ref.n_disconnected)
    if tcore.contract_for(algorithm).zero_disconnected and split != "none":
        assert dense.n_disconnected == 0
    assert dense.modularity == sort.modularity
    assert abs(dense.modularity - float(ref.modularity)) <= Q_ATOL
