"""The unsorted segment-sum kernel's wrapper (``csrc/onehot_segsum.cu``).

``onehot_segsum_cuda`` replaces the TPU kernel
``repro/kernels/onehot_segsum.py:onehot_segsum``: ``out[s] = sum of
values[i] over ids[i] == s``, in float32, deterministic.  The TPU kernel
accumulates ``onehot(ids)^T @ values`` into a VMEM-resident ``[C, D]``
output (``C*D*4 <= 8 MiB``).  On Hopper a stable counting sort of the rows
by bucket (``T`` consecutive segments) comes first, so the ids are read
twice whatever ``C`` is; then one block folds each piece of at most ``P``
rows of a bucket, each warp its sub-range into its own shared-memory tile,
and the pieces of a long bucket are summed in order (see
``csrc/onehot_segsum.cu``).  No float atomics; any ``C``.  Bound: bytes,
``N*D`` values and ``N`` ids read and ``C*D`` elements written.

:func:`plan_for` is the plan, from ``(N, C, D)`` and this module's
constants alone: the wrapper sizes grids and scratch from it without
reading anything back from the card, and the fold order it fixes
(:func:`piece_ranges`, :func:`warp_ranges`) is what :func:`emulate` runs on
the CPU, bit for bit the kernel's.

``onehot_segsum_cuda.launches`` counts kernel launches (a plain int): one
per call, which launches all five kernels, and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

TILE_FLOATS = 4096      # T * D of a bucket's tile in shared memory (16 KB)
MAX_CHANNELS = 3072     # the widest D taken
CHUNK_ROWS = 8192       # rows a block counts and sorts (counters shared)
WARP_ROWS = 1024        # ... and the unit of a chunk in global memory
PIECE_ROWS = 4096       # P: a fold block's rows at most
FOLD_WARPS = 4          # warps of a fold block, one tile each
SHARED_BUCKETS = 1024   # counters in shared memory up to this many buckets

_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p)
_SCRATCH_ARGS = _ARGS[5:14] + (ctypes.c_int,)
_lib: dict[str, object] = {}


class Plan(NamedTuple):
    """How one call cuts its work; the fields the kernels take, in order."""
    n: int                  # rows
    num_segments: int       # C
    d: int                  # channels
    tile_segments: int      # T: segments of a bucket
    buckets: int            # ceil(C / T)
    chunk_rows: int         # rows counted together (a block's or a warp's)
    chunks: int
    piece_rows: int         # P
    shared_counters: bool   # per-warp counters in shared memory

    @property
    def pieces(self) -> int:
        """Fold blocks: one a bucket, one a multiple of P below N."""
        return self.buckets + -(-self.n // self.piece_rows)

    @property
    def partial_slots(self) -> int:
        """Partial tiles: per multiple k of P, one for the piece starting at
        kP and one for the first piece of a bucket starting inside
        [kP, (k+1)P)."""
        return 2 * -(-self.n // self.piece_rows)


def plan_for(n: int, num_segments: int, d: int) -> Plan:
    """The plan for ``values [n, d]`` into ``num_segments >= 1`` segments.
    Up to ``SHARED_BUCKETS`` buckets a block counts and sorts a chunk of
    ``CHUNK_ROWS`` rows in shared memory; past that, counters go to global
    memory, a warp takes a chunk, and a chunk has at least as many rows as
    there are buckets, so that the ``buckets * chunks`` counters stay within
    ``n + buckets``."""
    if not 1 <= d <= MAX_CHANNELS:
        raise ValueError(f"the kernel takes 1 to {MAX_CHANNELS} channels, "
                         f"got {d}")
    if num_segments < 1:
        raise ValueError(f"need num_segments >= 1, got {num_segments}")
    tile = TILE_FLOATS // d
    buckets = -(-num_segments // tile)
    shared = buckets <= SHARED_BUCKETS
    chunk_rows = CHUNK_ROWS if shared else \
        -(-buckets // WARP_ROWS) * WARP_ROWS
    chunks = max(1, -(-n // chunk_rows))
    return Plan(n, num_segments, d, tile, buckets, chunk_rows, chunks,
                PIECE_ROWS, shared)


def piece_ranges(start: int, stop: int, piece_rows: int = PIECE_ROWS
                 ) -> list[tuple[int, int]]:
    """A bucket's rows ``[start, stop)`` of the permuted array cut at the
    multiples of ``piece_rows``: its pieces, in order."""
    cuts = range((start // piece_rows + 1) * piece_rows, stop, piece_rows)
    bounds = [start, *cuts, stop]
    return list(zip(bounds[:-1], bounds[1:]))


def warp_ranges(start: int, stop: int) -> list[tuple[int, int]]:
    """A piece's rows ``[start, stop)`` split among its ``FOLD_WARPS`` warps:
    contiguous, whole 32-row groups but for the last, some maybe empty."""
    q = -(-(-(-(stop - start) // FOLD_WARPS)) // 32) * 32
    out = []
    for w in range(FOLD_WARPS):
        lo = min(stop, start + w * q)
        out.append((lo, min(stop, lo + q)))
    return out


def emulate(values: torch.Tensor, ids: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    """The kernel's function in the kernel's float32 order, on the CPU: per
    (segment, channel), a left fold from 0 of each warp's rows
    (``index_add_`` folds in index order on the CPU), the warp tiles added
    in warp order, the piece sums in piece order; returned in ``values``'
    type.  ``values [N, D]`` on the CPU, ``ids`` int32 ``[N]``."""
    n, d = values.shape
    plan = plan_for(n, num_segments, d)
    t = plan.tile_segments
    x = values.float()
    keep = ((ids >= 0) & (ids < num_segments)).nonzero()[:, 0]
    bucket = ids[keep].long() // t
    order = torch.sort(bucket, stable=True).indices      # the scatter's
    rows = keep[order]
    seg = ids[rows].long() - bucket[order] * t
    val = x[rows]
    sizes = torch.bincount(bucket, minlength=plan.buckets)
    ends = torch.cumsum(sizes, 0).tolist()
    out = torch.zeros((plan.buckets * t, d), dtype=torch.float32)
    for b in sizes.nonzero()[:, 0].tolist():    # an empty bucket stays 0
        acc = None
        for lo, hi in piece_ranges(ends[b - 1] if b else 0, ends[b],
                                   plan.piece_rows):
            tiles = torch.zeros((FOLD_WARPS, t, d), dtype=torch.float32)
            for w, (a, z) in enumerate(warp_ranges(lo, hi)):
                tiles[w].index_add_(0, seg[a:z], val[a:z])
            piece = tiles[0]
            for w in range(1, FOLD_WARPS):
                piece = piece + tiles[w]
            acc = piece if acc is None else acc + piece
        out[b * t:(b + 1) * t] = acc
    return out[:num_segments].to(values.dtype)


def _entry(symbol: str):
    """``"launch"`` or ``"scratch"`` of the built ``csrc/onehot_segsum.cu``,
    once its constants are found equal to this module's, on which
    :func:`emulate` relies."""
    if not _lib:
        lib = _build.load("onehot_segsum")
        got = (ctypes.c_longlong * 7)()
        lib.onehot_segsum_constants.restype = None
        lib.onehot_segsum_constants(got)
        want = (TILE_FLOATS, MAX_CHANNELS, CHUNK_ROWS, WARP_ROWS, PIECE_ROWS,
                FOLD_WARPS, SHARED_BUCKETS)
        if tuple(got) != want:
            raise RuntimeError(f"csrc/onehot_segsum.cu's constants "
                               f"{tuple(got)} differ from the plan's {want}")
        size = lib.onehot_segsum_scratch_bytes
        size.argtypes = list(_SCRATCH_ARGS)
        size.restype = ctypes.c_longlong
        _lib["scratch"] = size
        _lib["launch"] = _build.bind("onehot_segsum", "onehot_segsum", _ARGS)
    return _lib[symbol]


def scratch_bytes(plan: Plan, itemsize: int) -> int:
    """Bytes of the kernels' one scratch buffer for ``plan`` and values of
    ``itemsize`` bytes, from the source's own layout (``carve`` there);
    builds the library at first use."""
    got = _entry("scratch")(*plan[:8], int(plan.shared_counters), itemsize)
    if got < 0:
        raise ValueError(f"the kernel does not take the plan {plan}")
    return got


def onehot_segsum_cuda(values: torch.Tensor, ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Launch the kernel: ``values [N, D]`` (float32/float16/bfloat16,
    contiguous, on CUDA, ``D <= MAX_CHANNELS``) summed in float32 by int32
    ``ids [N]`` in ``[0, num_segments)`` into ``[num_segments, D]`` of
    ``values``' type; a row whose id lies outside that range adds nothing,
    as in the TPU kernel's one-hot.  Raises on anything the kernel does not
    take."""
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
    plan = plan_for(n, num_segments, d)
    scratch = torch.empty(scratch_bytes(plan, values.element_size()),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = _entry("launch")(
            values.data_ptr(), ids.data_ptr(), scratch.data_ptr(),
            scratch.numel(), out.data_ptr(), *plan[:8],
            int(plan.shared_counters), code,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "onehot_segsum")
    onehot_segsum_cuda.launches += 1
    return out


onehot_segsum_cuda.launches = 0
