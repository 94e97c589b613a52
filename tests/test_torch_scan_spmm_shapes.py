"""The plain versions of the prefix sum and the bucketed SpMM, held against
the JAX package at the shapes where their Hopper kernels branch.

On the card, ``csrc/cumsum.cu`` and ``csrc/spmm.cu`` are held to the plain
versions (``kernels/ref.py``) that CPU tensors run, so these tests check
that yardstick against ``repro.kernels.ops`` (``impl="xla"``, and
``impl="pallas"`` in interpret mode, as ``tests/test_kernels.py`` runs it)
at the same shapes, with the tolerances of ``tests/test_torch_ops.py``:

* ``cumsum``: tiles of 8192 elements of the flat ``[M*D]`` array for D in
  {1, 2, 4} (each edge and one row either side), 128-row by 32-column
  tiles for any other D (one and two column chunks), 16-bit inputs, and
  ``segsum_sorted`` over the same tile edges;
* ``spmm``: K across the 8-wide gather groups and the 32-wide id chunks, D
  within one 128-channel pass and past it, bfloat16 x, out-of-range ids (against ``impl="pallas"`` only: the
  reference's XLA path clamps them, ROADMAP C.3), and a NaN and an inf
  under a zero weight (against ``impl="xla"`` only: the Pallas kernel's
  one-hot matmul spreads a NaN of x to every row of its block).

Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

J_IMPLS = ("pallas", "xla")
HALF_TOL = dict(rtol=3e-2, atol=3e-2)   # the reference's bf16 bound
TORCH_16 = {np.float16: torch.float16, "bfloat16": torch.bfloat16}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    """float32 numpy of a torch or jax array of any float type."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# --- cumsum and segsum_sorted --------------------------------------------------

ROWS_EDGES = [(8192 // d + off, d) for d in (1, 2, 4) for off in (-1, 0, 1)]
COLS_EDGES = [(127, 3), (128, 3), (129, 3), (130, 33), (257, 64)]


@pytest.mark.parametrize("m,d", ROWS_EDGES + COLS_EDGES)
@pytest.mark.parametrize("impl", J_IMPLS)
def test_cumsum_at_the_kernel_tiles(m, d, impl):
    x = np.random.default_rng(m * 7 + d).normal(size=(m, d)).astype(np.float32)
    got = tops.cumsum(_t(x))
    assert got.dtype == torch.float32 and got.shape == (m, d)
    want = jops.cumsum(jnp.asarray(x), impl=impl, block_m=1024)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("m,d", [(8193, 1), (4095, 2), (2049, 4), (129, 3)])
@pytest.mark.parametrize("dtype", [np.float16, "bfloat16"])
@pytest.mark.parametrize("impl", J_IMPLS)
def test_cumsum_16_bit_inputs(m, d, dtype, impl):
    """16-bit x, accumulated and returned in float32.  The XLA path returns
    x's type, so it is held on x's float32 upcast (as tests/test_torch_ops.py
    does); the Pallas kernel takes x as it is."""
    rng = np.random.default_rng(m + d)
    x16 = torch.from_numpy(rng.normal(size=(m, d)).astype(np.float32)).to(
        TORCH_16[dtype])
    got = tops.cumsum(x16)
    assert got.dtype == torch.float32
    x32 = x16.float().numpy()
    jx = jnp.asarray(x32)
    if impl == "pallas":
        jx = jx.astype(jnp.float16 if dtype is np.float16 else jnp.bfloat16)
    want = jops.cumsum(jx, impl=impl, block_m=1024)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("m,nseg,d", [(8191, 40, 1), (8193, 700, 1),
                                      (4097, 33, 2), (2049, 9, 4),
                                      (129, 20, 3)])
@pytest.mark.parametrize("impl", J_IMPLS)
def test_segsum_sorted_at_the_kernel_tiles(m, nseg, d, impl):
    rng = np.random.default_rng(m + nseg + d)
    ids = np.sort(rng.integers(0, nseg, m)).astype(np.int32)
    x = rng.normal(size=(m, d)).astype(np.float32)
    got = tops.segsum_sorted(_t(x), _t(ids), nseg + 2)
    want = jops.segsum_sorted(jnp.asarray(x), jnp.asarray(ids), nseg + 2,
                              impl=impl, block_m=1024)
    assert got.shape == (nseg + 2, d)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-4)


# --- spmm ------------------------------------------------------------------------

def _spmm_inputs(n, k, nx, d, seed):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, nx, (n, k)).astype(np.int32)
    w = rng.normal(size=(n, k)).astype(np.float32)
    w[rng.random((n, k)) < 0.1] = 0.0                 # padding slots
    x = rng.normal(size=(nx, d)).astype(np.float32)
    return nbr, w, x


# K around the gather group (8) and the id chunk (32); D within one
# 128-channel pass and past it
@pytest.mark.parametrize("k", [1, 7, 8, 9, 31, 32, 33, 40])
@pytest.mark.parametrize("d", [1, 2, 4, 130])
@pytest.mark.parametrize("impl", J_IMPLS)
def test_spmm_at_the_kernel_branches(k, d, impl):
    nbr, w, x = _spmm_inputs(64, k, 300, d, k * 1000 + d)
    got = tops.spmm(_t(nbr), _t(w), _t(x))
    want = jops.spmm(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x),
                     impl=impl, block_n=64)
    assert got.shape == (64, d)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("k,d", [(33, 3), (10, 602), (16, 8)])
@pytest.mark.parametrize("impl", J_IMPLS)
def test_spmm_bf16_x(k, d, impl):
    """bfloat16 x, at an odd D, at D = 602 (five channel passes) and at
    D = 8."""
    nbr, w, x = _spmm_inputs(64, k, 200, d, k + d)
    got = tops.spmm(_t(nbr), _t(w), _t(x).to(torch.bfloat16))
    want = jops.spmm(jnp.asarray(nbr), jnp.asarray(w),
                     jnp.asarray(x).astype(jnp.bfloat16), impl=impl,
                     block_n=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **HALF_TOL)


@pytest.mark.parametrize("k", [9, 33])
def test_spmm_out_of_range_ids_past_a_gather_group(k):
    nbr, w, x = _spmm_inputs(64, k, 50, 4, k)
    nbr[[3, 9, 40, 63], [k - 1, 8, 0, k - 1]] = (-1, 50, 2**31 - 1, -7)
    got = tops.spmm(_t(nbr), _t(w), _t(x))
    want = jops.spmm(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x),
                     impl="pallas", block_n=64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-4)


def test_spmm_nan_and_inf_under_a_zero_weight():
    nbr, w, x = _spmm_inputs(64, 12, 100, 6, 5)
    x[5, 2] = np.nan
    x[9, 4] = np.inf
    w[(nbr == 5) | (nbr == 9)] = 0.0
    got = tops.spmm(_t(nbr), _t(w), _t(x)).numpy()
    want = _np(jops.spmm(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x),
                         impl="xla"))
    named = ((nbr == 5) | (nbr == 9)).any(axis=1)
    assert named.any() and not named.all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[named]).any(axis=1).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)
