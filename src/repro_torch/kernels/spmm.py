"""The bucketed-SpMM kernel's wrapper (``csrc/spmm.cu``).

``bucket_spmm_cuda`` replaces the TPU kernel ``repro/kernels/spmm.py:
bucket_spmm``: ``out[i] = sum_k w[i, k] * x[nbr[i, k]]``.  The TPU kernel
keeps ``x`` in VMEM (``Nx*D*4 <= 8 MiB``) and gathers by a one-hot matmul;
on Hopper one warp per output row loads the row's ids and weights once,
keeps a group of 8 gathers of rows of ``x`` in flight, and folds the
neighbours in order, so any ``Nx`` is taken.
Bound: bytes, ``N*K*8`` (ids and weights) plus the rows of ``x`` that some
neighbour names read once and ``N*D`` elements written; all ``N*K*D``
gathered elements pass through L2.

``bucket_spmm_cuda.launches`` counts kernel launches (a plain int): one per
launch, nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p)


def bucket_spmm_cuda(nbr: torch.Tensor, w: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: int32 ``nbr [N, K]`` and float32 ``w [N, K]``
    gather-and-sum rows of ``x [Nx, D]`` (float32/float16/bfloat16) into
    ``[N, D]`` of ``x``'s type; all contiguous, on one CUDA device.  A
    neighbour outside ``[0, Nx)`` adds 0, as in the TPU kernel's one-hot
    gather (padding: an in-bounds id with ``w == 0``, gathered and
    multiplied all the same).  Raises on anything the kernel does not
    take."""
    code = _build.float_code(x.dtype)
    if nbr.dtype != torch.int32 or w.dtype != torch.float32:
        raise TypeError(f"need int32 nbr and float32 w, got {nbr.dtype} "
                        f"and {w.dtype}")
    if not (x.is_cuda and nbr.device == x.device and w.device == x.device):
        raise ValueError("nbr, w and x must lie on one CUDA device")
    if nbr.dim() != 2 or w.shape != nbr.shape or x.dim() != 2:
        raise ValueError(f"need nbr [N, K], w [N, K] and x [Nx, D], got "
                         f"{tuple(nbr.shape)}, {tuple(w.shape)} and "
                         f"{tuple(x.shape)}")
    if not (nbr.is_contiguous() and w.is_contiguous() and x.is_contiguous()):
        raise ValueError("nbr, w and x must be contiguous")
    n, k = nbr.shape
    d = x.shape[1]
    if k >= 2**31 or d >= 2**31:
        raise ValueError("the kernel indexes K and D with int32")
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    launch = _build.bind("spmm", "bucket_spmm", _ARGS)
    with torch.cuda.device(x.device):
        err = launch(nbr.data_ptr(), w.data_ptr(), x.data_ptr(),
                     out.data_ptr(), n, x.shape[0], k, d, code,
                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bucket_spmm")
    bucket_spmm_cuda.launches += 1
    return out


bucket_spmm_cuda.launches = 0
