"""The flash-attention forward kernel's wrapper (``csrc/flash_attn.cu``).

``flash_attention_cuda`` replaces the TPU kernel
``repro/kernels/flash_attn.py:flash_attention_fwd`` (body
``_flash_kernel``): attention with an online softmax in float32, a causal
and/or sliding-window mask, causal tiles above the diagonal skipped, output
in ``q``'s type.  Unlike the TPU path it reads the ``[B, S, H, Dh]`` layout
through its strides and maps query head ``h`` to kv head ``h // (Hq /
Hkv)``, so neither a transpose nor the repeated kv heads are materialised,
and keys at or beyond ``Sk`` are masked rather than padded.  Bound:
operations, ``4*Dh`` flops per (query, key) pair the mask lets through.

``flash_attention_cuda.launches`` counts kernel launches (a plain int): one
per launch, nowhere else.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# q, k, v, out, strides; batch, sq, sk, hq, hkv, dh, causal, window; scale;
# dtype, stream
_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.POINTER(ctypes.c_longlong),)
         + (ctypes.c_int,) * 8 + (ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p))
MAX_HEAD_DIM = 256
_I32 = 2**31 - 1


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """Launch the kernel: ``q [B, Sq, Hq, Dh]``, ``k, v [B, Sk, Hkv, Dh]``
    of one float type (float32/float16/bfloat16) on one CUDA device, each
    with a unit-stride last dimension, ``Hq % Hkv == 0`` and ``Dh <= 256``.
    Returns ``[B, Sq, Hq, Dh]`` in ``q``'s type.  Raises on anything the
    kernel does not take."""
    code = _build.float_code(q.dtype)
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k and v must share one type, got {q.dtype}, "
                        f"{k.dtype} and {v.dtype}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B, Sq, Hq, Dh] and k, v [B, Sk, Hkv, Dh], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"q and k disagree in batch or head size: "
                         f"{tuple(q.shape)} vs {tuple(k.shape)}")
    if hkv == 0 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes 1 <= Dh <= {MAX_HEAD_DIM}, "
                         f"got {dh}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need a unit-stride last dimension")
    if max(b, hq) > 65535 or max(sq, sk) > _I32 // 2:
        raise ValueError("shape beyond the kernel's grid")
    if window is not None and not 0 <= window <= _I32:
        raise ValueError(f"window must be a non-negative int, got {window}")
    out = torch.empty((b, sq, hq, dh), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    launch = _build.bind("flash_attn", "flash_attention_fwd", _ARGS)
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     strides, b, sq, sk, hq, hkv, dh, int(causal),
                     -1 if window is None else window, 1.0 / math.sqrt(dh),
                     code, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
