"""The port's ``segreduce_sorted`` max/min against the reference's IEEE
semantics, bit for bit.

``repro.kernels.ops.segreduce_sorted`` folds f32 max/min with
``jnp.maximum``/``jnp.minimum`` (``impl="xla"``, and the Pallas kernel run
in interpret mode as ``tests/test_seg_backend.py`` runs it): -0 is below +0,
so a segment's max is +0 when it holds any +0 among its zero maxima and its
min is -0 when it holds any -0; a NaN anywhere in a segment makes it NaN.
``repro_torch.kernels.ops.segreduce_sorted`` on a CPU tensor runs the plain
version of the CUDA kernel (``kernels/ref.py``), which the card holds the
kernel to bit for bit.  Inputs: fixed cases (±0 ties in both orders, a NaN
alone and among finite values, ±inf, empty segments) and draws from a
numpy seed over a pool of such values, at D = 1 and 2.  Comparison: the
int32 bits, with NaN equal to NaN whatever its payload; no tolerance.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

J_IMPLS = ("xla", "pallas")
NAN = np.float32(np.nan)
POOL = np.array([-0.0, 0.0, 1.0, -1.0, 2.5, np.inf, -np.inf, np.nan],
                np.float32)


def _bits_equal(got: np.ndarray, want: np.ndarray) -> bool:
    """Equal int32 bits, or NaN on both sides."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    same = got.view(np.int32) == want.view(np.int32)
    if got.dtype == np.float32:
        same |= np.isnan(got) & np.isnan(want)
    return bool(same.all())


def _assert_reference_bits(values, ids, nseg, op, block_m=8):
    got = tops.segreduce_sorted(torch.from_numpy(values),
                                torch.from_numpy(ids), nseg, op=op).numpy()
    for impl in J_IMPLS:
        want = np.asarray(jops.segreduce_sorted(
            jnp.asarray(values), jnp.asarray(ids), nseg, op=op, impl=impl,
            block_m=block_m))
        assert _bits_equal(got, want), (
            f"op={op} impl={impl}:\n port {got!r}\n  ref {want!r}")


def test_signed_zero_and_nan_case():
    """The case that shows the fault: values [-0, +0 | +0, -0 | 1, NaN |
    2, NaN] over four segments.  The reference gives max [+0, +0, nan,
    nan] and min [-0, -0, nan, nan]."""
    v = np.array([-0.0, 0.0, 0.0, -0.0, 1.0, NAN, 2.0, NAN], np.float32)
    ids = np.array([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    mx = tops.segreduce_sorted(torch.from_numpy(v), torch.from_numpy(ids),
                               4, op="max").numpy()
    mn = tops.segreduce_sorted(torch.from_numpy(v), torch.from_numpy(ids),
                               4, op="min").numpy()
    assert not np.signbit(mx[:2]).any()
    assert np.signbit(mn[:2]).all()
    assert np.isnan(mx[2:]).all() and np.isnan(mn[2:]).all()
    for op in ("max", "min"):
        _assert_reference_bits(v, ids, 4, op)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("d", [1, 2])
def test_fixed_special_values(op, d):
    """±0 ties in both orders, a NaN alone, a NaN first and last among
    finite values, ±inf alone and against finite values, an empty head,
    empty middle and empty tail segments (identity ±inf)."""
    rows = [
        (1, [-0.0, 0.0]), (1, [0.0, -0.0]), (2, [-0.0, -0.0]),
        (3, [0.0, 0.0]), (5, [NAN]), (6, [NAN, 1.0, 2.0]),
        (7, [3.0, -1.0, NAN]), (8, [np.inf]), (9, [-np.inf]),
        (10, [np.inf, 5.0, -np.inf]), (11, [-0.0]), (12, [0.0]),
        (13, [-np.inf, -0.0, -3.0]),
    ]
    ids = np.array([s for s, vs in rows for _ in vs], np.int32)
    col = np.array([x for _, vs in rows for x in vs], np.float32)
    v = col if d == 1 else np.stack([col, col[::-1].copy()], axis=1)
    # ids are sorted, so the reversed column is the same multiset per
    # segment only by chance: it tests other ties, not a mirror image
    _assert_reference_bits(v, ids, 16, op)


@pytest.mark.parametrize("op", ["max", "min"])
@pytest.mark.parametrize("d", [1, 2])
@pytest.mark.parametrize("seed", range(3))
def test_drawn_special_values(op, d, seed):
    """Values drawn from a pool of ±0, ±1, ±inf and NaN (so ties and NaNs
    are common), short runs with empty segments between and after them.
    Shapes are fixed so the reference compiles once per (op, D)."""
    rng = np.random.default_rng(seed)
    m, nseg = 96, 40
    ids = np.sort(rng.integers(0, nseg - 4, m)).astype(np.int32)
    pick = rng.choice(len(POOL), size=(m, d), p=[.25, .25, .1, .1, .1,
                                                  .05, .05, .1])
    v = POOL[pick]
    _assert_reference_bits(v[:, 0] if d == 1 else v, ids, nseg, op)


def test_order_key_is_monotone_and_involutive():
    """The plain version's key: strictly increasing over the finite floats
    and ±inf in order (with -0 below +0), and its own inverse."""
    xs = np.array([-np.inf, -3.4e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0,
                   3.4e38, np.inf], np.float32)
    bits = torch.from_numpy(xs.view(np.int32))
    keys = tref.order_key(bits)
    assert bool((keys[1:] > keys[:-1]).all())
    assert torch.equal(tref.order_key(keys), bits)


def test_int32_sum_wraps_as_the_reference():
    """The int32 sum wraps modulo 2^32, as the reference's does."""
    big = np.iinfo(np.int32).max
    v = np.array([big, 1, big, big, -big, -2, 5], np.int32)
    ids = np.array([0, 0, 1, 1, 2, 2, 4], np.int32)
    _assert_reference_bits(v, ids, 6, "sum")
    got = tops.segreduce_sorted(torch.from_numpy(v), torch.from_numpy(ids),
                                6, op="sum").numpy()
    assert got[0] == np.iinfo(np.int32).min and got[1] == -2
