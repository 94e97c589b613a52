"""The fixed-order flat sum (``repro_torch.kernels.ops.sum_inorder``) and
the decision sums built on it, against a numpy left fold.

``sum_inorder`` folds chunks of ``FLAT_CHUNK`` values in index order from
+0.0, then the chunk totals the same way, level after level until one value
is left, through ``segreduce_sorted``: the card's in-order kernel and the
CPU's plain version take that order, so 2m (``Graph.total_weight_2m``) and
the two sums of ``realized_modularity``, which feed the Eq.-2 scores and
the best-Q and convergence tests, have the same bits on every device.
Here the CPU path is held bit for bit to an explicit numpy tree of left
folds (one float32 add at a time) on seeded data whose magnitudes spread
over twelve binary orders, so that another order would round differently;
lengths include an empty input, one row, lengths that are not a multiple
of the chunk, and one that takes three levels.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.local_move import realized_modularity
from repro_torch.graph import rmat_graph
from repro_torch.kernels import ops


def _left_fold(x: np.ndarray) -> np.float32:
    acc = np.float32(0.0)
    for v in x:
        acc = np.float32(acc + v)
    return acc


def _tree_fold(x: np.ndarray) -> np.float32:
    """Left folds of FLAT_CHUNK values, level after level, to one value."""
    c = ops.FLAT_CHUNK
    while True:
        x = np.array([_left_fold(x[i:i + c])
                      for i in range(0, max(x.shape[0], 1), c)], np.float32)
        if x.shape[0] == 1:
            return x[0]


def _data(m, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=m) * 2.0 ** rng.integers(-6, 6, m)) \
        .astype(np.float32)


@pytest.mark.parametrize("m", [0, 1, 7, 1023, 1024, 1025, 3 * 1024 + 7,
                               20_000, 1024 * 1024 + 3])
def test_sum_inorder_is_the_tree_of_folds(m):
    x = _data(m, m)
    got = ops.sum_inorder(torch.from_numpy(x))
    assert got.shape == () and got.dtype == torch.float32
    want = _tree_fold(x)
    assert got.numpy().view(np.int32) == np.array(want).view(np.int32)


def test_sum_inorder_signed_zero():
    """Each level starts from +0.0: -0.0 rows sum to +0.0."""
    for x in (np.array([-0.0], np.float32), np.full(2500, -0.0, np.float32)):
        got = ops.sum_inorder(torch.from_numpy(x))
        assert float(got) == 0.0 and not bool(torch.signbit(got))


def test_sum_inorder_order_matters_here():
    """The data do round differently in another order, so the equality
    above pins the order and not only the value."""
    x = _data(20_000, 20_000)
    assert _tree_fold(x) != _left_fold(x)


def test_sum_inorder_stays_near_the_exact_sum():
    """Integer weights past 2**24 in all, as 2m at scale 21: the tree keeps
    its partial sums small and lands within a few ulps of the exact sum,
    where one flat left fold drifts by hundreds."""
    x = np.random.default_rng(2).integers(1, 4, 12_000_000).astype(np.float32)
    exact = int(x.astype(np.int64).sum())
    got = float(ops.sum_inorder(torch.from_numpy(x)))
    flat = float(ops.segreduce_sorted(torch.from_numpy(x), torch.zeros(
        x.shape[0], dtype=torch.int32), 1)[0])
    ulp = 2.0 ** (np.floor(np.log2(exact)) - 23)
    assert abs(got - exact) <= 8 * ulp < abs(flat - exact)


def test_total_weight_2m_is_the_fixed_order():
    g = rmat_graph(scale=8, edge_factor=8, seed=3, device="cpu")
    w = g.w.numpy()
    got = g.total_weight_2m()
    assert got.numpy().view(np.int32) == np.array(_tree_fold(w)).view(np.int32)


def test_realized_modularity_uses_the_fixed_order():
    g = rmat_graph(scale=8, edge_factor=8, seed=3, device="cpu")
    rng = np.random.default_rng(1)
    C = torch.from_numpy(rng.integers(0, 40, g.nv).astype(np.int32))
    K = ops.segreduce_sorted(g.w, g.src, g.nv)
    Sigma = ops.segment_sum_inorder(K, C, g.nv)
    two_m = g.total_weight_2m()
    got = realized_modularity(g.src, g.dst, g.w, C, Sigma, two_m)
    w_in = np.where((C[g.src] == C[g.dst]).numpy(), g.w.numpy(), 0.0) \
        .astype(np.float32)
    s = Sigma.numpy()
    internal = _tree_fold(w_in)
    sig2 = _tree_fold((s * s).astype(np.float32))
    tm = np.float32(two_m.numpy())
    want = np.float32(np.float32(internal / tm) -
                      np.float32(sig2 / np.float32(tm * tm)))
    assert got.numpy().view(np.int32) == np.array(want).view(np.int32)
