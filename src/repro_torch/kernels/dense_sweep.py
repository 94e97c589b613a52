"""The wrapper of the dense half-sweep kernel (``csrc/dense_sweep.cu``).

``dense_half_sweep_cuda`` runs one half-sweep of the dense scan's local
move (``core/local_move.py:_half_sweep_dense``, whose PyTorch body is its
plain version) in two launches: a block a vertex row folds the row's
edges in index order into per-community sums and takes the row's Eq.-2
argmax; then a thread a community recomputes Sigma in index order.  Up to
:data:`MAX_NV` a row's two ``[nv]`` sums lie in shared memory; past it in
a global scratch of :data:`SCRATCH_BLOCKS` slices of two rows, one for
each block of a grid that walks the vertex rows, so any ``nv`` the plain
version takes runs on the card.  It has no TPU counterpart: the
reference's dense scan (``repro/core/local_move.py:_half_sweep_dense``)
is XLA code.  The plain version spends dozens of PyTorch launches a
half-sweep, and on a small graph each costs more host time than the work
(ROADMAP C.12).
Bound: bytes, the edges (``12 * m``) and seven ``[nv]`` vectors read, five
written, against eight float operations a cell that holds weight (at most
``m``), two an edge and ``nv`` adds for Sigma.

``dense_modularity_cuda`` is the sweep loop's realized modularity in one
launch (the plain version's ``ops.sum_inorder`` trees spend about two
dozen).

``dense_half_sweep_cuda.launches`` and ``dense_modularity_cuda.launches``
count calls that launch (plain ints; one a call, though a half-sweep
launches two kernels).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGS = (ctypes.c_void_p,) * 10 + (ctypes.c_int, ctypes.c_int) + \
    (ctypes.c_void_p,) * 6 + (ctypes.c_int, ctypes.c_void_p)
MAX_NV = 24 * 1024      # two [nv] float32 rows in a block's shared memory
SCRATCH_BLOCKS = 1024   # past MAX_NV: the grid, a scratch slice a block


def edge_rows(src: torch.Tensor, nv: int):
    """``(order, row_ptr)``: the edge ids stably sorted by ``src`` (so each
    row's edges keep index order) and the int32 ``[nv + 1]`` row offsets."""
    s_src, order = torch.sort(src, stable=True)
    bounds = torch.arange(nv + 1, dtype=torch.int32, device=src.device)
    row_ptr = torch.searchsorted(s_src, bounds, out_int32=True)
    return order.to(torch.int32), row_ptr


def dense_half_sweep_cuda(rows, dst, w, C, K, Sigma, two_m, movable,
                          target_ok=None, anchored=True):
    """One dense half-sweep on the card: ``(C_new, Sigma_new, move, want,
    best)``, each ``[nv]``, where ``best`` is a row's best candidate score
    (the plain version's ``gain`` is its sum over moved rows).  ``rows``
    is :func:`edge_rows` of the edges' sources; ``two_m`` a 0-dim float32
    tensor on the card (as the plain version divides by it); ``movable``
    and ``target_ok`` bool ``[nv]``.  Raises on anything the kernel does
    not take."""
    order, row_ptr = rows
    nv = C.shape[0]
    dev = C.device
    tensors = [order, row_ptr, dst, w, C, K, Sigma, movable]
    if target_ok is not None:
        tensors.append(target_ok)
    if not all(t.is_cuda and t.device == dev and t.is_contiguous()
               for t in tensors):
        raise ValueError("the dense sweep takes contiguous tensors on one "
                         "CUDA device")
    if not (isinstance(two_m, torch.Tensor) and two_m.device == dev
            and two_m.dim() == 0 and two_m.dtype == torch.float32):
        raise ValueError("two_m must be a 0-dim float32 tensor on the card")
    if (order.dtype, row_ptr.dtype, dst.dtype, C.dtype) != (torch.int32,) * 4 \
            or (w.dtype, K.dtype, Sigma.dtype) != (torch.float32,) * 3 \
            or movable.dtype != torch.bool \
            or (target_ok is not None and target_ok.dtype != torch.bool):
        raise TypeError("the dense sweep takes int32 ids, float32 weights "
                        "and bool masks")
    if nv < 1 or row_ptr.shape[0] != nv + 1 or K.shape[0] != nv \
            or Sigma.shape[0] != nv or movable.shape[0] != nv:
        raise ValueError("the dense sweep takes nv >= 1 and [nv] vectors")
    C_new = torch.empty(nv, dtype=torch.int32, device=dev)
    Sigma_new = torch.empty(nv, dtype=torch.float32, device=dev)
    move = torch.empty(nv, dtype=torch.bool, device=dev)
    want = torch.empty(nv, dtype=torch.bool, device=dev)
    best = torch.empty(nv, dtype=torch.float32, device=dev)
    blocks = min(nv, SCRATCH_BLOCKS)
    scratch = (None if nv <= MAX_NV else
               torch.empty(2 * nv * blocks, dtype=torch.float32, device=dev))
    launch = _build.bind("dense_sweep", "dense_half_sweep", _ARGS)
    with torch.cuda.device(dev):
        err = launch(order.data_ptr(), row_ptr.data_ptr(), dst.data_ptr(),
                     w.data_ptr(), C.data_ptr(), K.data_ptr(),
                     Sigma.data_ptr(), two_m.data_ptr(), movable.data_ptr(),
                     None if target_ok is None else target_ok.data_ptr(),
                     int(anchored), nv, C_new.data_ptr(), move.data_ptr(),
                     want.data_ptr(), best.data_ptr(), Sigma_new.data_ptr(),
                     None if scratch is None else scratch.data_ptr(),
                     blocks, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dense_half_sweep")
    dense_half_sweep_cuda.launches += 1
    return C_new, Sigma_new, move, want, best


dense_half_sweep_cuda.launches = 0

_Q_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_void_p, ctypes.c_void_p)
FLAT_CHUNK = 1024     # ops.FLAT_CHUNK: values one in-order fold takes


def dense_modularity_cuda(src, dst, w, C, Sigma, two_m) -> torch.Tensor:
    """The sweep loop's realized modularity (``core/local_move.py:
    realized_modularity`` without a group, its plain version) in one
    launch: the two ``ops.sum_inorder`` trees, over the masked weights and
    over Sigma^2, and ``internal / 2m - sig2 / (2m * 2m)``, the same bits.
    Returns a 0-dim float32 tensor on the card."""
    dev = C.device
    tensors = (src, dst, w, C, Sigma)
    if not all(t.is_cuda and t.device == dev and t.is_contiguous()
               for t in tensors):
        raise ValueError("the dense modularity takes contiguous tensors on "
                         "one CUDA device")
    if not (isinstance(two_m, torch.Tensor) and two_m.device == dev
            and two_m.dim() == 0 and two_m.dtype == torch.float32):
        raise ValueError("two_m must be a 0-dim float32 tensor on the card")
    if (src.dtype, dst.dtype, C.dtype) != (torch.int32,) * 3 \
            or (w.dtype, Sigma.dtype) != (torch.float32,) * 2:
        raise TypeError("the dense modularity takes int32 ids and float32 "
                        "weights")
    m, nv = src.shape[0], C.shape[0]
    half = 2 * max(-(-max(m, nv) // FLAT_CHUNK), 1)
    scratch = torch.empty(2 * half + 1, dtype=torch.float32, device=dev)
    q = scratch[2 * half]
    launch = _build.bind("dense_sweep", "dense_modularity", _Q_ARGS)
    with torch.cuda.device(dev):
        err = launch(src.data_ptr(), dst.data_ptr(), w.data_ptr(),
                     C.data_ptr(), Sigma.data_ptr(), two_m.data_ptr(), m, nv,
                     scratch.data_ptr(), half, q.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dense_modularity")
    dense_modularity_cuda.launches += 1
    return q


dense_modularity_cuda.launches = 0
