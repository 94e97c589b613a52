"""The wrappers of the scan kernels: the sorted segment reduce
(``csrc/segreduce.cu``) and the prefix sum (``csrc/cumsum.cu``).

``segreduce_sorted_cuda`` replaces the TPU kernel
``repro/kernels/segsum.py:_segscan_kernel`` (reached
through ``segscan_blocked`` and the boundary gather of
``repro/kernels/ops.py:segreduce_sorted``).  The TPU kernel streams a
segmented running scan through VMEM with a carry that resets at run starts,
then gathers each segment's last element; on Hopper one thread per
(segment, channel) folds its rows in index order and writes ``[nseg, D]``
directly.  The in-order fold keeps f32 run sums bit-identical to the
reference (see ``csrc/segreduce.cu`` for why that is load-bearing).

What bounds it on an H100: bytes.  ``M*D*4 + M*4 + (nseg+1)*4`` read
(values, the ids the offset search reads, the offsets) and ``nseg*D*4``
written; the arithmetic is one add or compare per element.  The design
keeps every byte to one pass except the offset search, and walks short
runs with coalesced loads; a power-law hub is walked by one thread, which
is the known weak spot.

``cumsum_cuda`` replaces ``repro/kernels/segsum.py:cumsum_blocked`` (body
``_cumsum_kernel``); its carry across blocks becomes a pass over the block
totals (see ``csrc/cumsum.cu``).  Bound: bytes, ``M*D`` elements read and
``M*D*4`` bytes written.

``segreduce_sorted_cuda.launches`` and ``cumsum_cuda.launches`` count kernel
launches (plain ints): one per launch, nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

OPS = {"sum": 0, "max": 1, "min": 2}
DTYPES = {torch.float32: 0, torch.int32: 1}


def scan_identity(op: str, dtype: torch.dtype):
    """Identity of ``op`` for ``dtype``: the empty-segment fill, equal to
    what ``jax.ops.segment_{sum,max,min}`` use (0 / dtype-min / dtype-max)."""
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("-inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


_SEGREDUCE_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p)
_CUMSUM_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def segreduce_sorted_cuda(values: torch.Tensor, ids: torch.Tensor,
                          num_segments: int, *, op: str = "sum"
                          ) -> torch.Tensor:
    """Launch the kernel: ``values [M, D]`` (f32 or int32, contiguous, on
    CUDA) reduced over nondecreasing int32 ``ids [M]`` into
    ``[num_segments, D]``.  Raises on anything the kernel does not take."""
    if op not in OPS:
        raise ValueError(f"op must be one of {tuple(OPS)}, got {op!r}")
    if values.dtype not in DTYPES:
        raise TypeError(f"values must be float32 or int32, got {values.dtype}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if not (values.is_cuda and ids.device == values.device):
        raise ValueError("values and ids must lie on one CUDA device")
    if values.dim() != 2 or values.shape[1] < 1 or ids.dim() != 1 \
            or ids.shape[0] != values.shape[0]:
        raise ValueError(
            f"need values [M, D>=1] and ids [M], got {tuple(values.shape)} "
            f"and {tuple(ids.shape)}")
    if not (values.is_contiguous() and ids.is_contiguous()):
        raise ValueError("values and ids must be contiguous")
    if values.shape[0] >= 2**31 or num_segments >= 2**31:
        raise ValueError("the kernel indexes rows and segments with int32")
    dev = values.device
    seg = torch.arange(num_segments + 1, dtype=torch.int32, device=dev)
    offsets = torch.searchsorted(ids, seg, out_int32=True)
    out = torch.empty((num_segments, values.shape[1]), dtype=values.dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    launch = _build.bind("segreduce", "segreduce_sorted", _SEGREDUCE_ARGS)
    with torch.cuda.device(dev):
        err = launch(
            values.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            num_segments, values.shape[1], OPS[op], DTYPES[values.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "segreduce_sorted")
    segreduce_sorted_cuda.launches += 1
    return out


segreduce_sorted_cuda.launches = 0


def cumsum_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the prefix-sum kernel (``csrc/cumsum.cu``): the inclusive sum
    along axis 0 of ``x [M, D]`` (float32/float16/bfloat16, contiguous, on
    CUDA) into float32 ``[M, D]``.  Raises on anything the kernel does not
    take.  One call launches the kernel's three passes and counts one."""
    code = _build.float_code(x.dtype)
    if not x.is_cuda:
        raise ValueError("x must lie on a CUDA device")
    if x.dim() != 2:
        raise ValueError(f"need x [M, D], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    m, d = x.shape
    if d > 65535:
        raise ValueError("the kernel takes at most 65535 columns")
    dev = x.device
    out = torch.empty((m, d), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        rows = _build.bind("cumsum", "cumsum_block_rows", ())()
        totals = torch.empty((-(-m // rows)) * d, dtype=torch.float32,
                             device=dev)
        err = _build.bind("cumsum", "cumsum_f32", _CUMSUM_ARGS)(
            x.data_ptr(), out.data_ptr(), totals.data_ptr(), m, d, code,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cumsum")
    cumsum_cuda.launches += 1
    return out


cumsum_cuda.launches = 0
