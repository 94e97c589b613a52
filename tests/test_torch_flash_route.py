"""The flash-attention tensor-core route, on the CPU.

``kernels/flash_attn.py:tensor_core_route`` decides, before launch, which
of the two kernels of ``csrc/flash_attn.cu`` takes a call; it is pure, so it
is tested here on CPU tensors.  The tensor-core kernel itself runs only on
the card, so its arithmetic is emulated here in torch, tile by tile as the
kernel does it: 64-key tiles, scores in log2 units (``scale * log2 e``) with
``exp2``, the running max and sum with the TPU kernel's guards, and P split
into 16-bit parts ``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)``, both
multiplied by V into one float32 accumulator.  The emulation is held

* to phase 5's bound of ``chip_smoke.py`` (the output's bf16 rounding,
  ``2^-8 * |out| + 1e-4``) against the plain version on float32 copies of
  the same inputs;
* with P kept in float32, on float32 inputs, to the reference's float32
  tolerance (rtol = atol = 2e-5) against ``repro.kernels.ops
  .flash_attention(impl="xla")``;

and P rounded once to bf16 is shown to miss that bound on the same inputs,
which is why the kernel splits it.  Inputs are made with numpy from a seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.flash_attn import (flash_attention_cuda,
                                            tensor_core_route)

LOG2E = 1.4426950408889634
BK = 64                                   # csrc/flash_attn.cu: tc::kBK


def emulate_tensor_core_kernel(q, k, v, *, causal, window, p_parts="split"):
    """``flash_fwd_wgmma``'s arithmetic on ``q [B, Sq, Hq, Dh]``, ``k, v
    [B, Sk, Hkv, Dh]``; returns ``[B, Sq, Hq, Dh]`` in ``q``'s type.

    ``p_parts``: ``"split"`` as the kernel does it (P_hi + P_lo in q's
    16-bit type), ``"one"`` (P rounded once), ``"f32"`` (P not rounded).
    Tiles outside a row's mask change nothing (the max stays, the
    correction is exactly 1, P is 0), so every tile is visited here; keys
    at or beyond Sk are absent, as the kernel masks TMA's zero fill."""
    b, sq, hq, dh = q.shape
    g = hq // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    # the kernel's scale_log2: float(1 / sqrt(Dh)) * float(log2 e) in f32
    scale = (torch.tensor(1.0 / math.sqrt(dh), dtype=torch.float32)
             * torch.tensor(LOG2E, dtype=torch.float32))
    q_pos = torch.arange(sq)[:, None]
    m = torch.full((b, hq, sq, 1), float("-inf"))
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, dh))
    for k0 in range(0, kf.shape[2], BK):
        kt, vt = kf[:, :, k0:k0 + BK], vf[:, :, k0:k0 + BK]
        x = (qf @ kt.transpose(-1, -2)) * scale
        k_pos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        seen = torch.ones((sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            seen &= k_pos <= q_pos
        if window is not None:
            seen &= q_pos - k_pos < window
        x = x.masked_fill(~seen, float("-inf"))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        m_safe = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.where(m == float("-inf"), 0.0, torch.exp2(m - m_safe))
        p = torch.exp2(x - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        if p_parts == "split":
            hi = p.to(q.dtype).float()
            pv = hi @ vt + (p - hi).to(q.dtype).float() @ vt
        elif p_parts == "one":
            pv = p.to(q.dtype).float() @ vt
        else:
            pv = p @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype).transpose(1, 2)


def _qkv(seed, b, sq, sk, hq, hkv, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, s, h, dh)).astype(np.float32)
                 for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))


def _bf16_err_over_tol(got, q, k, v, causal, window):
    """Largest err/tol of ``got`` against the plain version on float32
    copies of the inputs, tol = 2^-8 * |out| + 1e-4 (chip_smoke.py phase
    5)."""
    want = tref.flash_attention_gqa_ref(q.float(), k.float(), v.float(),
                                        causal=causal,
                                        window=window).double()
    tol = 2.0**-8 * want.abs() + 1e-4
    return float(((got.double() - want).abs() / tol).max())


# (b, sq, sk, hq, hkv, dh, causal, window)
SHAPES = [
    (1, 64, 64, 1, 1, 64, False, None),        # one tile
    (1, 512, 512, 4, 1, 64, True, None),       # GQA 4
    (1, 512, 512, 4, 4, 128, True, None),
    (1, 256, 256, 8, 1, 128, True, 100),       # GQA 8, window edge mid-tile
    (2, 200, 200, 4, 2, 64, True, 70),         # ragged S, GQA 2
    (1, 100, 333, 2, 2, 128, False, None),     # non-causal, Sq != Sk
]


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,window", SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_emulated_kernel_within_phase5_bound(b, sq, sk, hq, hkv, dh, causal,
                                             window, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype)
               for a in _qkv(sq + sk + dh, b, sq, sk, hq, hkv, dh))
    got = emulate_tensor_core_kernel(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == q.shape
    assert _bf16_err_over_tol(got, q, k, v, causal, window) <= 1.0


@pytest.mark.parametrize("b,sq,sk,hq,hkv,dh,causal,window", SHAPES)
def test_emulated_kernel_float32_matches_reference(b, sq, sk, hq, hkv, dh,
                                                   causal, window):
    arrs = _qkv(sq + sk + dh, b, sq, sk, hq, hkv, dh)
    got = emulate_tensor_core_kernel(*(torch.from_numpy(a) for a in arrs),
                                     causal=causal, window=window,
                                     p_parts="f32")
    want = jops.flash_attention(*(jnp.asarray(a) for a in arrs),
                                causal=causal, window=window, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dh", [64, 128])
def test_p_rounded_once_misses_the_bound(dh):
    """The reason for the split: on inputs where P_hi + P_lo stays inside
    the bound, P rounded once to bf16 lands several times outside it."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(dh, 1, 512, 512, 4, 1, dh))
    split = emulate_tensor_core_kernel(q, k, v, causal=True, window=None)
    once = emulate_tensor_core_kernel(q, k, v, causal=True, window=None,
                                      p_parts="one")
    assert _bf16_err_over_tol(split, q, k, v, True, None) <= 1.0
    assert _bf16_err_over_tol(once, q, k, v, True, None) > 2.0


def test_emulated_kernel_rows_that_see_nothing_are_zero():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(3, 1, 130, 130, 2, 1, 64))
    got = emulate_tensor_core_kernel(q, k, v, causal=True, window=0)
    assert torch.equal(got, torch.zeros_like(got))


# --- the route predicate -----------------------------------------------------

def _strided(shape, strides, dtype=torch.bfloat16, offset=0):
    n = offset + 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    return torch.zeros(n, dtype=dtype).as_strided(shape, strides, offset)


def _route(q, k=None, v=None):
    return tensor_core_route(q, q if k is None else k, q if v is None else v)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dh", [64, 128])
def test_route_takes_16_bit_dh_64_and_128(dtype, dh):
    q = torch.zeros((2, 70, 8, dh), dtype=dtype)
    kv = torch.zeros((2, 33, 2, dh), dtype=dtype)
    assert tensor_core_route(q, kv, kv)


@pytest.mark.parametrize("dh", [8, 32, 96, 200, 256])
def test_route_refuses_other_head_sizes(dh):
    assert not _route(torch.zeros((1, 64, 2, dh), dtype=torch.bfloat16))


def test_route_refuses_float32_and_mixed_types():
    q = torch.zeros((1, 64, 2, 64))
    assert not _route(q)
    assert not _route(q.bfloat16(), q.half(), q.bfloat16())
    assert not _route(q.bfloat16(), q.bfloat16(), q.half())


def test_route_refuses_misaligned_storage_offset():
    shape = (1, 64, 2, 64)
    aligned = _strided(shape, (8192, 128, 64, 1), offset=8)   # 16 bytes
    assert _route(aligned)
    for offset in (1, 2, 4):                                  # 2, 4, 8 bytes
        assert not _route(_strided(shape, (8192, 128, 64, 1), offset=offset))
    assert not _route(aligned, _strided(shape, (8192, 128, 64, 1), offset=3))


@pytest.mark.parametrize("strides", [
    (9000, 132, 64, 1),       # sequence stride 264 bytes
    (8192, 128, 68, 1),       # head stride 136 bytes
    (8196, 128, 64, 1),       # batch stride 16392 bytes
    (8192, 128, 64, 2),       # last dimension not unit-stride
    (8192, 0, 64, 1),         # a broadcast sequence
])
def test_route_refuses_strides_tma_cannot_read(strides):
    shape = (2, 64, 2, 64)
    bad = _strided(shape, strides)
    assert not _route(bad)
    good = torch.zeros(shape, dtype=torch.bfloat16)
    assert not tensor_core_route(good, bad, good)
    assert not tensor_core_route(good, good, bad)


def test_route_takes_transposed_views_and_ignores_size_one_strides():
    bhsd = torch.zeros((2, 4, 50, 64), dtype=torch.bfloat16)
    assert _route(bhsd.transpose(1, 2))           # [B, S, H, Dh] view
    # batch and head of size 1: their strides are never stepped
    assert _route(_strided((1, 64, 1, 128), (7, 128, 3, 1)))
    assert not _route(_strided((1, 64, 2, 128), (7, 128, 3, 1)))


def test_route_refuses_empty_keys():
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    assert not tensor_core_route(q, q[:, :0], q[:, :0])


def test_cpu_tensors_on_the_route_launch_nothing():
    q = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16)
    assert _route(q)
    before = (flash_attention_cuda.launches,
              flash_attention_cuda.tensor_core_launches)
    out = tops.flash_attention(q, q, q)
    assert out.dtype == q.dtype
    assert (flash_attention_cuda.launches,
            flash_attention_cuda.tensor_core_launches) == before
