"""The unsorted segment-sum kernel's wrapper (``csrc/onehot_segsum.cu``).

``onehot_segsum_cuda`` replaces the TPU kernel
``repro/kernels/onehot_segsum.py:onehot_segsum``: ``out[s] = sum of
values[i] over ids[i] == s``, in float32, deterministic.  The TPU kernel
accumulates ``onehot(ids)^T @ values`` into a VMEM-resident ``[C, D]``
output (``C*D*4 <= 8 MiB``); on Hopper each block owns a tile of segments
in shared memory and a slice of rows, each warp folds its rows into its
tile in index order, and a second pass sums the slices in order (see
``csrc/onehot_segsum.cu``).  No float atomics, so two launches give the
same bits, and any ``C`` is taken.  Bound: bytes, ``N*D`` values and ``N``
ids read and ``C*D`` elements written.

``onehot_segsum_cuda.launches`` counts kernel launches (a plain int): one
per call, which launches both passes, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
BLOCKS_PER_SM = 8     # slices are added until the grid has this many blocks
MIN_SLICE_ROWS = 1024  # ... but a slice keeps at least this many rows


def slices_for(n: int, tiles: int, sms: int) -> int:
    """Row slices of pass 1: enough blocks to fill the card, at most one per
    ``MIN_SLICE_ROWS`` rows."""
    want = -(-BLOCKS_PER_SM * sms // tiles)
    return max(1, min(want, -(-n // MIN_SLICE_ROWS), 65535))


def onehot_segsum_cuda(values: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Launch the kernel: ``values [N, D]`` (float32/float16/bfloat16,
    contiguous, on CUDA) summed in float32 by int32 ``ids [N]`` in
    ``[0, num_segments)`` into ``[num_segments, D]`` of ``values``' type;
    a row whose id lies outside that range adds nothing, as in the TPU
    kernel's one-hot.  Raises on anything the kernel does not take."""
    code = _build.float_code(values.dtype)
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if not (values.is_cuda and ids.device == values.device):
        raise ValueError("values and ids must lie on one CUDA device")
    if values.dim() != 2 or ids.dim() != 1 or ids.shape[0] != values.shape[0]:
        raise ValueError(f"need values [N, D] and ids [N], got "
                         f"{tuple(values.shape)} and {tuple(ids.shape)}")
    if not (values.is_contiguous() and ids.is_contiguous()):
        raise ValueError("values and ids must be contiguous")
    n, d = values.shape
    dev = values.device
    out = torch.empty((num_segments, d), dtype=values.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        tile_floats = _build.bind("onehot_segsum",
                                  "onehot_segsum_tile_floats", ())()
        if d > tile_floats:
            raise ValueError(f"the kernel takes at most {tile_floats} "
                             f"channels, got {d}")
        tile = tile_floats // d
        tiles = -(-num_segments // tile)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        slices = slices_for(n, tiles, sms)
        partial = torch.empty((slices, num_segments, d), dtype=torch.float32,
                              device=dev)
        err = _build.bind("onehot_segsum", "onehot_segsum", _ARGS)(
            values.data_ptr(), ids.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n, num_segments, d, tile, slices, code,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "onehot_segsum")
    onehot_segsum_cuda.launches += 1
    return out


onehot_segsum_cuda.launches = 0
