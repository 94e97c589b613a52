"""The port's kernel API held against the JAX package's, on the CPU.

``repro_torch.kernels.ops.{cumsum, segsum_sorted, segsum, spmm,
flash_attention}`` on CPU tensors run the plain versions of the CUDA
kernels (``kernels/ref.py``).  Each is held against ``repro.kernels.ops``
both with ``impl="pallas"`` (the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it) and ``impl="xla"``, at the reference's
own cases and tolerances (``tests/test_kernels.py``): ragged lengths, empty
segments, zero-weight padding, float16/bfloat16 inputs, grouped-query
heads, causal and windowed masks.  Inputs are made with numpy from a seed.

Two stated differences of the reference's paths, not of the function:

* ``cumsum``: the port returns float32, as the reference's kernel path
  does; the reference's XLA path casts back to the input's type, so a
  float16 input is held against the XLA path on its float32 upcast.
* ``flash_attention`` without a causal mask and with ``Sk`` not a multiple
  of ``block_k``: the reference's Pallas path pads k and v with zeros and
  attends to the padding (ROADMAP queue C).  The port masks keys beyond
  ``Sk``, as the oracle does, so that case is held against ``impl="xla"``
  only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attn import flash_attention_cuda
from repro_torch.kernels.onehot_segsum import onehot_segsum_cuda, plan_for
from repro_torch.kernels.segsum import cumsum_cuda
from repro_torch.kernels.spmm import bucket_spmm_cuda

J_IMPLS = ("pallas", "xla")
HALF_TOL = dict(rtol=3e-2, atol=3e-2)   # the reference's bf16 bound


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    """float32 numpy of a torch or jax array of any float type."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# --- cumsum ------------------------------------------------------------------

@pytest.mark.parametrize("m,d,block", [
    (256, 1, 64), (512, 8, 128), (1024, 16, 256), (2048, 128, 1024),
])
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_cumsum(m, d, block, dtype):
    x = np.random.default_rng(m + d).normal(size=(m, d)).astype(dtype)
    got = tops.cumsum(_t(x))
    assert got.dtype == torch.float32 and got.shape == (m, d)
    pallas = jops.cumsum(jnp.asarray(x), impl="pallas", block_m=block)
    # the XLA path returns the input's type; compare on the float32 upcast
    xla = jops.cumsum(jnp.asarray(x.astype(np.float32)), impl="xla")
    for want in (pallas, xla):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("impl", J_IMPLS)
def test_cumsum_ragged_and_1d(impl):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(100, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tops.cumsum(_t(x)).numpy(),
        _np(jops.cumsum(jnp.asarray(x), impl=impl, block_m=64)),
        rtol=2e-5, atol=1e-4)
    x1 = rng.normal(size=77).astype(np.float32)
    got = tops.cumsum(_t(x1))
    assert got.shape == (77,)
    np.testing.assert_allclose(
        got.numpy(), _np(jops.cumsum(jnp.asarray(x1), impl=impl, block_m=32)),
        rtol=2e-5, atol=1e-4)


# --- segsum_sorted -----------------------------------------------------------

@pytest.mark.parametrize("m,nseg,d", [(256, 7, 4), (1024, 64, 16),
                                      (2048, 1, 8), (512, 512, 2)])
@pytest.mark.parametrize("impl", J_IMPLS)
def test_segsum_sorted(m, nseg, d, impl):
    rng = np.random.default_rng(m * nseg + d)
    ids = np.sort(rng.integers(0, nseg, m)).astype(np.int32)
    x = rng.normal(size=(m, d)).astype(np.float32)
    got = tops.segsum_sorted(_t(x), _t(ids), nseg)
    want = jops.segsum_sorted(jnp.asarray(x), jnp.asarray(ids), nseg,
                              impl=impl, block_m=256)
    assert got.dtype == torch.float32 and got.shape == (nseg, d)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("impl", J_IMPLS)
def test_segsum_sorted_1d_and_empty_segments(impl):
    ids = np.array([0, 0, 3, 3, 3, 7], np.int32)
    x = np.arange(6, dtype=np.float32) + 1
    got = tops.segsum_sorted(_t(x), _t(ids), 9)
    want = np.zeros(9, np.float32)
    want[0], want[3], want[7] = 3.0, 12.0, 6.0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        got.numpy(), _np(jops.segsum_sorted(jnp.asarray(x), jnp.asarray(ids),
                                            9, impl=impl, block_m=2)),
        rtol=1e-6)


def test_segsum_sorted_ref_is_the_direct_sum():
    rng = np.random.default_rng(5)
    ids = np.sort(rng.integers(0, 40, 600)).astype(np.int32)
    x = rng.normal(size=(600, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tref.segsum_sorted_ref(_t(x), _t(ids), 45).numpy(),
        _np(jref.segsum_sorted_ref(jnp.asarray(x), jnp.asarray(ids), 45)),
        rtol=1e-6, atol=1e-6)


# --- spmm --------------------------------------------------------------------

@pytest.mark.parametrize("n,k,nx,d", [
    (64, 4, 32, 8), (192, 16, 100, 32), (128, 8, 256, 128), (70, 3, 50, 5),
])
@pytest.mark.parametrize("impl", J_IMPLS)
def test_spmm(n, k, nx, d, impl):
    rng = np.random.default_rng(n + k + nx + d)
    nbr = rng.integers(0, nx, (n, k)).astype(np.int32)
    w = rng.normal(size=(n, k)).astype(np.float32)
    w[rng.random((n, k)) < 0.1] = 0.0                 # padding slots
    x = rng.normal(size=(nx, d)).astype(np.float32)
    got = tops.spmm(_t(nbr), _t(w), _t(x))
    want = jops.spmm(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x),
                     impl=impl, block_n=64)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-4)


def test_spmm_zero_weight_padding():
    nbr = np.zeros((64, 4), np.int32)                 # bogus neighbours
    w = np.zeros((64, 4), np.float32)                 # but zero weight
    x = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    got = tops.spmm(_t(nbr), _t(w), _t(x))
    assert float(got.abs().max()) == 0.0


def test_spmm_beyond_the_tpu_envelope():
    """x of 40000 x 128 float32 (20 MB) is past the TPU kernel's 8 MiB VMEM
    envelope, where the reference takes its XLA path; the port takes any
    Nx, so it is held against that path."""
    rng = np.random.default_rng(3)
    nbr = rng.integers(0, 40000, (64, 2)).astype(np.int32)
    w = rng.normal(size=(64, 2)).astype(np.float32)
    x = rng.normal(size=(40000, 128)).astype(np.float32)
    want = jops.spmm(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x))
    np.testing.assert_allclose(tops.spmm(_t(nbr), _t(w), _t(x)).numpy(),
                               _np(want), rtol=2e-5, atol=1e-4)


def test_spmm_out_of_range_neighbours_add_zero():
    """A neighbour outside [0, Nx) adds 0, as in the reference's kernel
    (its one-hot row is 0).  Held against ``impl="pallas"`` only: the
    reference's XLA path clamps such a gather to the nearest row instead
    (ROADMAP queue C)."""
    rng = np.random.default_rng(22)
    nbr = rng.integers(0, 16, (64, 3)).astype(np.int32)
    nbr[[5, 9, 30], [1, 0, 2]] = (-1, 16, 500)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    x = rng.normal(size=(16, 4)).astype(np.float32)
    got = tops.spmm(_t(nbr), _t(w), _t(x))
    want = jops.spmm(jnp.asarray(nbr), jnp.asarray(w), jnp.asarray(x),
                     impl="pallas", block_n=64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-4)
    empty = tops.spmm(_t(nbr), _t(w), torch.zeros((0, 4)))
    assert empty.shape == (64, 4) and not empty.any()


@pytest.mark.parametrize("impl", J_IMPLS)
def test_spmm_bf16(impl):
    rng = np.random.default_rng(9)
    nbr = rng.integers(0, 48, (64, 6)).astype(np.int32)
    w = rng.normal(size=(64, 6)).astype(np.float32)
    x = rng.normal(size=(48, 16)).astype(np.float32)
    got = tops.spmm(_t(nbr), _t(w), _t(x).to(torch.bfloat16))
    want = jops.spmm(jnp.asarray(nbr), jnp.asarray(w),
                     jnp.asarray(x).astype(jnp.bfloat16), impl=impl,
                     block_n=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **HALF_TOL)


# --- segsum (unsorted) -------------------------------------------------------

@pytest.mark.parametrize("n,nseg,d,block", [
    (512, 10, 4, 128), (1024, 50, 16, 256), (256, 256, 8, 256),
    (300, 37, 3, 128),
])
@pytest.mark.parametrize("impl", J_IMPLS)
def test_segsum(n, nseg, d, block, impl):
    rng = np.random.default_rng(n + nseg + d)
    v = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(0, nseg, n).astype(np.int32)
    got = tops.segsum(_t(v), _t(ids), nseg + 3)        # 3 empty segments
    want = jops.segsum(jnp.asarray(v), jnp.asarray(ids), nseg + 3, impl=impl,
                       block_n=block)
    assert got.dtype == torch.float32 and got.shape == (nseg + 3, d)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-4)
    assert not got[nseg:].any()


@pytest.mark.parametrize("impl", J_IMPLS)
def test_segsum_1d(impl):
    rng = np.random.default_rng(21)
    v = rng.normal(size=100).astype(np.float32)
    ids = rng.integers(0, 5, 100).astype(np.int32)
    got = tops.segsum(_t(v), _t(ids), 5)
    assert got.shape == (5,)
    np.testing.assert_allclose(
        got.numpy(), _np(jops.segsum(jnp.asarray(v), jnp.asarray(ids), 5,
                                     impl=impl, block_n=64)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", J_IMPLS)
def test_segsum_float16(impl):
    """float16 values are summed in float32 and returned in float16, as the
    reference's kernel path does; half-precision bound."""
    rng = np.random.default_rng(4)
    v = rng.normal(size=(384, 4)).astype(np.float16)
    ids = rng.integers(0, 20, 384).astype(np.int32)
    got = tops.segsum(_t(v), _t(ids), 20)
    assert got.dtype == torch.float16
    want = jops.segsum(jnp.asarray(v), jnp.asarray(ids), 20, impl=impl,
                       block_n=128)
    np.testing.assert_allclose(_np(got), _np(want), **HALF_TOL)


@pytest.mark.parametrize("impl", J_IMPLS)
def test_segsum_drops_out_of_range_ids(impl):
    """A row whose id lies outside [0, C) adds nothing: its one-hot row is
    0 in the reference's kernel, and its XLA path drops it."""
    rng = np.random.default_rng(21)
    v = rng.normal(size=(128, 3)).astype(np.float32)
    ids = rng.integers(0, 7, 128).astype(np.int32)
    ids[[3, 40, 77]] = (-1, 7, 1000)
    got = tops.segsum(_t(v), _t(ids), 7)
    want = jops.segsum(jnp.asarray(v), jnp.asarray(ids), 7, impl=impl,
                       block_n=64)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("n,nseg,d,buckets,chunks,pieces", [
    (2_097_153, 857_336, 1, 210, 257, 723), (100, 1, 1, 1, 1, 2),
    (10**9, 1, 1, 1, 122_071, 244_142), (0, 5, 3, 1, 1, 1)])
def test_segsum_plan_needs_only_the_shape(n, nseg, d, buckets, chunks, pieces):
    """The kernel's grid and scratch follow from (N, C, D) alone: no count
    is read back from the card and no SM count enters the fold order."""
    p = plan_for(n, nseg, d)
    assert (p.buckets, p.chunks, p.pieces) == (buckets, chunks, pieces)
    assert p.buckets * p.tile_segments >= nseg
    assert p.chunks * p.chunk_rows >= n


# --- flash attention ---------------------------------------------------------

def _qkv(seed, b, sq, sk, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, dh)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, dh)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, dh)).astype(np.float32))


def _flash_both(arrs, causal, window, impls, block=16, dtype="float32",
                **tol):
    """Both packages on the same inputs, cast to ``dtype`` by each."""
    tq, tk, tv = (_t(a).to(getattr(torch, dtype)) for a in arrs)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in arrs)
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == tq.shape and got.dtype == tq.dtype
    for impl in impls:
        want = jops.flash_attention(jq, jk, jv, causal=causal,
                                    window=window, impl=impl, block_q=block,
                                    block_k=block)
        np.testing.assert_allclose(_np(got), _np(want), err_msg=impl, **tol)
    return got


@pytest.mark.parametrize("b,h,sq,sk,dh,causal,window", [
    (2, 3, 64, 64, 32, True, None),
    (1, 2, 128, 128, 64, True, 8),
    (2, 2, 32, 96, 16, False, None),
    (1, 1, 16, 16, 8, True, 4),
])
def test_flash_attention(b, h, sq, sk, dh, causal, window):
    _flash_both(_qkv(sq + sk + dh, b, sq, sk, h, h, dh), causal, window,
                J_IMPLS, rtol=2e-5, atol=2e-5)


def test_flash_attention_ref_matches_the_oracle():
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 3, 24, 8)).astype(np.float32)
               for _ in range(3))
    for causal, window in ((True, None), (False, 5), (True, 3)):
        np.testing.assert_allclose(
            tref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                     window=window).numpy(),
            _np(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=causal,
                                         window=window)),
            rtol=2e-5, atol=2e-5)


def test_flash_attention_ref_chunks_heads(monkeypatch):
    rng = np.random.default_rng(12)
    q, k, v = (_t(rng.normal(size=(1, 5, 20, 8)).astype(np.float32))
               for _ in range(3))
    whole = tref.flash_attention_ref(q, k, v, window=6)
    monkeypatch.setattr(tref, "SCORE_CHUNK_ELEMS", 2 * 20 * 20)
    assert torch.equal(tref.flash_attention_ref(q, k, v, window=6), whole)


def test_flash_attention_bf16():
    _flash_both(_qkv(1, 1, 64, 64, 2, 2, 32), True, None, J_IMPLS, block=32,
                dtype="bfloat16", **HALF_TOL)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, 6)])
def test_flash_attention_gqa(causal, window):
    """Eight query heads over two kv heads, S = 40 (ragged for block 16).
    The causal cases hold against both paths of the reference."""
    impls = J_IMPLS if causal else ("xla",)
    _flash_both(_qkv(2, 2, 40, 40, 8, 2, 16), causal, window, impls,
                rtol=2e-5, atol=2e-5)


def test_flash_attention_non_causal_ragged_keys():
    """Non-causal, Sk = 40 with block 16: held against the XLA path only,
    because the reference's Pallas path attends to its zero padding of k
    and v (ROADMAP queue C); the port masks keys beyond Sk."""
    _flash_both(_qkv(3, 1, 40, 40, 2, 2, 16), False, None, ("xla",),
                rtol=2e-5, atol=2e-5)


def test_flash_attention_sq_ne_sk_and_float16():
    _flash_both(_qkv(4, 1, 16, 48, 4, 2, 8), True, None, J_IMPLS,
                rtol=2e-5, atol=2e-5)
    _flash_both(_qkv(5, 1, 32, 32, 4, 4, 16), True, 8, J_IMPLS,
                dtype="float16", **HALF_TOL)


def test_flash_attention_fully_masked_rows_are_zero():
    q, k, v = (_t(a) for a in _qkv(6, 1, 8, 8, 1, 1, 4))
    out = tops.flash_attention(q, k, v, causal=True, window=0)
    assert torch.equal(out, torch.zeros_like(out))


# --- dispatch and the wrappers on the CPU ------------------------------------

def test_cpu_tensors_launch_nothing():
    wrappers = (cumsum_cuda, onehot_segsum_cuda, bucket_spmm_cuda,
                flash_attention_cuda)
    before = [f.launches for f in wrappers]
    x = torch.randn(32, 2)
    ids = torch.zeros(32, dtype=torch.int32)
    tops.cumsum(x)
    tops.segsum_sorted(x, ids, 2)
    tops.segsum(x, ids, 2)
    tops.spmm(torch.zeros((4, 2), dtype=torch.int32), torch.ones(4, 2), x)
    q = torch.randn(1, 4, 2, 8)
    tops.flash_attention(q, q, q)
    assert [f.launches for f in wrappers] == before


def test_wrappers_refuse_cpu_tensors_and_bad_types():
    """A wrapper launches its kernel or raises: it never runs the plain
    version, so a CPU tensor handed to it directly is refused."""
    x = torch.randn(16, 2)
    ids = torch.zeros(16, dtype=torch.int32)
    nbr = torch.zeros((4, 2), dtype=torch.int32)
    q = torch.randn(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cumsum_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        onehot_segsum_cuda(x, ids, 3)
    with pytest.raises(ValueError, match="CUDA"):
        bucket_spmm_cuda(nbr, torch.ones(4, 2), x)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    with pytest.raises(TypeError):
        cumsum_cuda(x.double())
    with pytest.raises(TypeError):
        onehot_segsum_cuda(x, ids.long(), 3)
    with pytest.raises(TypeError):
        bucket_spmm_cuda(nbr, torch.ones(4, 2, dtype=torch.float64), x)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q.half(), q)


def test_unknown_device_is_refused():
    x = torch.randn(4, 2, device="meta")
    with pytest.raises(ValueError, match="no cumsum for device meta"):
        tops.cumsum(x)
