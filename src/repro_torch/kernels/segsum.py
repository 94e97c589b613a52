"""The wrappers of the scan kernels: the sorted segment reduce
(``csrc/segreduce.cu``) and the prefix sum (``csrc/cumsum.cu``).

``segreduce_sorted_cuda`` replaces the TPU kernel
``repro/kernels/segsum.py:_segscan_kernel`` (reached
through ``segscan_blocked`` and the boundary gather of
``repro/kernels/ops.py:segreduce_sorted``).  The TPU kernel streams a
segmented running scan through VMEM with a carry that resets at run starts,
then gathers each segment's last element.  On Hopper it takes one of two
routes, chosen by :func:`route` from (op, dtype) before launch.  Both cut
the rows into tiles of :data:`TILE_ROWS`, one block a tile, and neither
searches for segment offsets or syncs with the host:

* ``"in-order"``, the f32 sum: each segment is the strict float32 left
  fold of its rows in index order from +0.0, which keeps f32 run sums
  bit-identical to the reference (see ``csrc/segreduce.cu`` for why that is
  load-bearing).  A thread folds the segments that start among its rows;
  a segment that crosses a tile edge hands its fold on to the next tile as
  a carry.  :func:`inorder_plan` states which tile writes each segment and
  which tiles hand its carry on, and :func:`emulate_inorder` folds by that
  plan on the CPU.
* ``"tiled"``, max and min over f32 and int32 and the int32 sum: folds that
  are exact in any order (f32 max/min through an order-preserving int32
  key of the float bits, with -0 below +0 and NaN absorbing, as the
  reference's ``jnp.maximum``/``minimum``).  Blocks reduce their tile with
  a block-wide segmented scan and combine segments that cross a tile edge
  with exact integer atomics (which a first, small launch sets to the
  identity).  The same bits on every run.

What bounds it on an H100: bytes, ``M*D*4 + M*4`` read (values and ids)
and ``nseg*D*4`` written; for the in-order route also the chain of
dependent float adds along the longest segment (its rows times the add's
latency), which no order-keeping design can shorten.

``cumsum_cuda`` replaces ``repro/kernels/segsum.py:cumsum_blocked`` (body
``_cumsum_kernel``); its carry across blocks becomes a one-pass decoupled
look-back over tiles taken by ticket, with float64 carries (see
``csrc/cumsum.cu``).  Bound: bytes, ``M*D`` elements read and ``M*D*4``
bytes written, each once.

``segreduce_sorted_cuda.launches`` and ``cumsum_cuda.launches`` count kernel
launches (plain ints): one per call that launches, nowhere else; a call
whose route launches two kernels counts one.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
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


TILE_ROWS = 2048     # rows a block of either route takes (csrc kTile)

_SEGREDUCE_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
_CUMSUM_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)


def route(op: str, dtype: torch.dtype) -> str:
    """The kernel route of ``(op, dtype)``: ``"in-order"`` for the f32 sum,
    ``"tiled"`` for the folds that are exact in any order."""
    return "in-order" if op == "sum" and dtype == torch.float32 else "tiled"


def _bind_segreduce():
    """The C entry point, after checking that the source's tile size is
    :data:`TILE_ROWS`."""
    rows = _build.bind("segreduce", "segreduce_tile_rows", ())()
    if rows != TILE_ROWS:
        raise RuntimeError(f"csrc/segreduce.cu tiles {rows} rows, the "
                           f"wrapper expects {TILE_ROWS}")
    return _build.bind("segreduce", "segreduce_sorted", _SEGREDUCE_ARGS)


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
    if values.shape[0] >= 2**31 - 1 or num_segments >= 2**31 - 1:
        raise ValueError("the kernel indexes rows and segments with int32")
    dev = values.device
    out = torch.empty((num_segments, values.shape[1]), dtype=values.dtype,
                      device=dev)
    if out.numel() == 0:
        return out
    scratch = None
    if route(op, values.dtype) == "in-order":
        # the ticket and one carry word a (tile, channel); zeroed by the launch
        tiles = -(-values.shape[0] // TILE_ROWS)
        scratch = torch.empty(1 + tiles * values.shape[1], dtype=torch.int64,
                              device=dev)
    launch = _bind_segreduce()
    with torch.cuda.device(dev):
        err = launch(
            values.data_ptr(), ids.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            values.shape[0], num_segments, values.shape[1], OPS[op],
            DTYPES[values.dtype], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "segreduce_sorted")
    segreduce_sorted_cuda.launches += 1
    return out


segreduce_sorted_cuda.launches = 0


class InorderPlan(NamedTuple):
    """How the in-order route splits the work of one call
    (``csrc/segreduce.cu:segreduce_inorder``), tile by tile.

    ``lo``, ``hi``: the range of segments each tile writes from its staging
    buffer (those that end in it, and the empty ones between its ids).
    ``carry_in``: the tile's first segment goes on from the tile before;
    ``carry_out``: its last segment goes on into the next.  ``first_head``:
    the tile-local row of the tile's first segment start, or its length.
    ``writer``: the tile that writes each segment, -1 for the empty head and
    tail that all blocks fill; ``writes``: how many writers each segment
    has.  ``chains``: for each segment that crosses a tile edge, the tiles
    that hand its carry on, in order.
    """
    lo: np.ndarray
    hi: np.ndarray
    carry_in: np.ndarray
    carry_out: np.ndarray
    first_head: np.ndarray
    writer: np.ndarray
    writes: np.ndarray
    chains: dict


def inorder_plan(ids, num_segments: int, tile_rows: int = TILE_ROWS
                 ) -> InorderPlan:
    """The in-order route's plan for sorted int32 ``ids`` (numpy or a CPU
    tensor) over ``num_segments``: the same formulas as the kernel."""
    ids = np.asarray(ids, dtype=np.int64)
    m = ids.shape[0]
    base = np.arange(-(-m // tile_rows), dtype=np.int64) * tile_rows
    last = np.minimum(base + tile_rows, m) - 1
    before = np.where(base > 0, ids[np.maximum(base - 1, 0)], 0)
    carry_in = (base > 0) & (before == ids[base])
    nxt = np.minimum(last + 1, max(m - 1, 0))
    carry_out = (last + 1 < m) & (ids[nxt] == ids[last])
    lo = np.maximum(np.where(base > 0, before + 1, ids[base]), 0)
    hi = np.minimum(ids[last] + np.where(carry_out, 0, 1), num_segments)
    head = np.ones(m, bool)
    head[1:] = ids[1:] != ids[:-1]
    head[base] = ~carry_in
    rows = np.flatnonzero(head)
    at = np.searchsorted(rows, base)
    first_head = np.where(at < rows.size, rows[np.minimum(at, rows.size - 1)],
                          m) - base
    first_head = np.minimum(first_head, last + 1 - base)

    writer = np.full(num_segments, -2, np.int64)
    writes = np.zeros(num_segments, np.int64)
    for t in range(base.size):
        if hi[t] > lo[t]:
            writer[lo[t]:hi[t]] = t
            writes[lo[t]:hi[t]] += 1
        ends_here = first_head[t] < last[t] + 1 - base[t] or not carry_out[t]
        if carry_in[t] and ends_here and 0 <= before[t] < num_segments:
            writer[before[t]] = t
            writes[before[t]] += 1
    if m:                              # the head and tail all blocks fill
        edges = (range(0, min(ids[0], num_segments)),
                 range(max(ids[-1] + 1, 0), num_segments))
    else:
        edges = (range(num_segments),)
    for r in edges:
        writer[r.start:r.stop] = -1
        writes[r.start:r.stop] += 1
    chains: dict = {}
    for t in np.flatnonzero(carry_out):
        chains.setdefault(int(ids[last[t]]), []).append(int(t))
    return InorderPlan(lo, hi, carry_in, carry_out, first_head, writer,
                       writes, chains)


def emulate_inorder(values, ids, num_segments: int,
                    tile_rows: int = TILE_ROWS) -> torch.Tensor:
    """The in-order route's f32 sum of ``values [M, D]`` over sorted
    ``ids``, folded on the CPU the way :func:`inorder_plan` splits it: each
    segment's rows tile by tile, from +0.0 where it starts and from the
    carry of the tile before where it goes on, in float32
    (``np.add.accumulate`` adds strictly left to right)."""
    v = np.asarray(values, dtype=np.float32)
    ids = np.asarray(ids, dtype=np.int64)
    p = inorder_plan(ids, num_segments, tile_rows)
    out = np.zeros((num_segments, v.shape[1]), np.float32)
    carry = None
    for t in range(p.lo.size):
        a = t * tile_rows
        b = min(a + tile_rows, ids.shape[0])
        starts = np.flatnonzero(np.diff(ids[a:b], prepend=-1) != 0)
        for k, r in enumerate(starts):
            e = starts[k + 1] if k + 1 < starts.size else b - a
            first = carry if (r == 0 and p.carry_in[t]) else \
                np.zeros(v.shape[1], np.float32)
            acc = np.add.accumulate(np.concatenate(
                [first[None], v[a + r: a + e]]), axis=0, dtype=np.float32)[-1]
            if e == b - a and p.carry_out[t]:
                carry = acc
            else:
                out[ids[a + r]] = acc
    return torch.from_numpy(out)


def cumsum_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the prefix-sum kernel (``csrc/cumsum.cu``): the inclusive sum
    along axis 0 of ``x [M, D]`` (float32/float16/bfloat16, contiguous, on
    CUDA) into float32 ``[M, D]``.  Raises on anything the kernel does not
    take.  One call zeroes the kernel's status words (``torch.zeros`` on
    the stream), launches its one scan and counts one."""
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
        nbytes = _build.bind("cumsum", "cumsum_scratch_bytes",
                             (ctypes.c_longlong, ctypes.c_int),
                             ctypes.c_longlong)(m, d)
        # the ticket and a status word a tile and channel
        status = torch.zeros(-(-nbytes // 8), dtype=torch.int64, device=dev)
        err = _build.bind("cumsum", "cumsum_f32", _CUMSUM_ARGS)(
            x.data_ptr(), out.data_ptr(), status.data_ptr(), m, d, code,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "cumsum")
    cumsum_cuda.launches += 1
    return out


cumsum_cuda.launches = 0
