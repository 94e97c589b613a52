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

Two kernels serve it, chosen before launch by :func:`tensor_core_route`:
``flash_fwd_wgmma`` (tensor cores, TMA) for bfloat16/float16 inputs with
``Dh`` 64 or 128 that TMA can read, ``flash_fwd_kernel`` (CUDA cores,
float32 arithmetic) for the rest.

``flash_attention_cuda.launches`` counts kernel launches (a plain int): one
per launch, nowhere else; ``flash_attention_cuda.tensor_core_launches``
counts those that went to ``flash_fwd_wgmma``.

The card route is also a registered op, ``torch.ops.repro_torch.
flash_attention`` (:func:`flash_attention_op`), which
``ops.flash_attention`` calls for CUDA tensors.  Its CUDA kernel is
:func:`flash_attention_cuda`, so a real CUDA tensor launches exactly as
before; it has no CPU kernel, so nothing falls back.  As an op it also has
a fake kernel (shapes and dtypes, for tracing under ``FakeTensorMode``
with no launch), a flop formula for ``torch.utils.flop_counter`` (``4 * B
* Hq * Dh`` times :func:`attention_pairs`) and, once
:func:`repro_torch.distributed.dtensor_rules.register` has run, a DTensor
sharding rule.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build

# q, k, v, out, strides; batch, sq, sk, hq, hkv, dh, causal, window; scale;
# dtype, stream
_ARGS = ((ctypes.c_void_p,) * 4 + (ctypes.POINTER(ctypes.c_longlong),)
         + (ctypes.c_int,) * 8 + (ctypes.c_float, ctypes.c_int,
                                  ctypes.c_void_p))
MAX_HEAD_DIM = 256
TENSOR_CORE_HEAD_DIMS = (64, 128)
_I32 = 2**31 - 1
_TMA_STRIDE_LIMIT = 2**40        # bytes


def tensor_core_route(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> bool:
    """Whether ``flash_attention_cuda`` sends these inputs to the
    tensor-core kernel: bfloat16 or float16 (all three alike), ``Dh`` in
    ``TENSOR_CORE_HEAD_DIMS``, ``Sk >= 1``, and what TMA requires of each of
    q, k and v: a 16-byte aligned base pointer, a unit-stride last dimension
    and batch, sequence and head strides that are positive multiples of 16
    bytes below 2^40 (a dimension of size 1 is never stepped, so its stride
    does not count).  Pure: it reads shapes, strides and pointers only, on
    any device."""
    if q.dtype not in (torch.bfloat16, torch.float16) or not (
            k.dtype == v.dtype == q.dtype):
        return False
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return False
    if q.shape[3] not in TENSOR_CORE_HEAD_DIMS or k.shape[1] < 1:
        return False
    for t in (q, k, v):
        if t.data_ptr() % 16 or t.stride(3) != 1:
            return False
        for d in range(3):
            nbytes = t.stride(d) * t.element_size()
            if t.shape[d] > 1 and not (
                    0 < nbytes < _TMA_STRIDE_LIMIT and nbytes % 16 == 0):
                return False
    return True


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         window: int | None = None) -> torch.Tensor:
    """Launch a kernel: ``q [B, Sq, Hq, Dh]``, ``k, v [B, Sk, Hkv, Dh]``
    of one float type (float32/float16/bfloat16) on one CUDA device, each
    with a unit-stride last dimension, ``Hq % Hkv == 0`` and ``Dh <= 256``;
    the tensor-core kernel where :func:`tensor_core_route` says so, else
    the CUDA-core kernel.  Returns ``[B, Sq, Hq, Dh]`` in ``q``'s type.
    Raises on anything the kernels do not take."""
    _build.float_code(q.dtype)          # raises on a type no kernel takes
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
    tensor_cores = tensor_core_route(q, k, v)
    launch_kernel(q, k, v, out, causal=causal, window=window,
                  tensor_cores=tensor_cores)
    flash_attention_cuda.launches += 1
    if tensor_cores:
        flash_attention_cuda.tensor_core_launches += 1
    return out


def launch_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, *, causal: bool, window: int | None,
                  tensor_cores: bool) -> None:
    """One launch, into a contiguous ``out``, of the kernel named by
    ``tensor_cores``, on inputs that :func:`flash_attention_cuda` has
    checked (and, for the tensor cores, that :func:`tensor_core_route`
    takes).  Not counted: the wrapper counts its own launches, and a
    measuring script may time the CUDA-core kernel on inputs both take."""
    b, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3])
    launch = _build.bind("flash_attn", "flash_attention_fwd_wgmma"
                         if tensor_cores else "flash_attention_fwd", _ARGS)
    with torch.cuda.device(q.device):
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     strides, b, sq, sk, hq, hkv, dh, int(causal),
                     -1 if window is None else window, 1.0 / math.sqrt(dh),
                     _build.float_code(q.dtype),
                     torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")


flash_attention_cuda.launches = 0
flash_attention_cuda.tensor_core_launches = 0


def attention_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask lets through, per batch and head: query
    ``i`` sees keys ``[max(i - window + 1, 0), min(i, sk - 1)]`` (causal;
    ``sk - 1`` without), none where that range is empty."""
    import numpy as np

    qpos = np.arange(sq, dtype=np.int64)
    hi = np.minimum(qpos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window is not None \
        else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


@torch.library.custom_op(
    "repro_torch::flash_attention", mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, bool causal, int? window) "
           "-> Tensor")
def flash_attention_op(q, k, v, causal, window):
    """The card route as a registered op: :func:`flash_attention_cuda`."""
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, window):
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, window, *,
                           out_shape=None, **kwargs) -> int:
    b, sq, hq, dh = q_shape
    return 4 * b * hq * dh * attention_pairs(sq, k_shape[1], causal, window)
