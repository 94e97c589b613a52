"""The wrappers of the dense scan's kernels (``csrc/dense_sweep.cu``).

``dense_half_sweep_cuda`` runs one half-sweep of the dense scan's local
move (``core/local_move.py:_half_sweep_dense``, whose PyTorch body is its
plain version) in two launches: a warp a vertex row folds the row's edges,
32 at a time, onto their communities in index order and takes the row's
Eq.-2 argmax over the communities its edges reach; then one block
groups every 32-vertex window by new community at once, and one warp
walks the windows in vertex order folding each community's K into Sigma
(no sort).  ``dense_modularity_cuda`` is the
sweep loop's realized modularity in one launch: a block a 1,024-value leaf
chunk of either ``ops.sum_inorder`` tree, the last block by a ticket in the
launch's own scratch folding the upper levels.  Neither replaces a TPU kernel: the reference's dense
scan and realized modularity (``repro/core/local_move.py:361
_half_sweep_dense`` and ``:124 realized_modularity``) are XLA code.  Their
plain versions spend dozens of PyTorch launches a call, and on a small
graph each costs more host time than the work (ROADMAP C.12).

Bound: at the dense scan's sizes (``nv <= 1025``, ``m <= 16,384``) the
bytes take under a microsecond, so each kernel is bound by its longest
chain of dependent adds (every float sum folds in index order from +0.0:
the longest cell's edges and the largest community for the half-sweep,
1,024 leaf values and the upper levels for the modularity, 4 cycles an
add) and by launch latency.  The design gathers and scores in parallel so
that nothing but those folds is serial; see the source's note.

Up to :data:`MAX_NV` a warp's accumulators (two ``[nv]`` float rows and an
``[nv]`` tag row) and Sigma's walk lie in shared memory; past it in one
global scratch, :data:`SCRATCH_WARPS` warps walking the vertex rows, so
any ``nv`` the plain version takes runs on the card.  :func:`sweep_plan`
and :func:`modularity_plan` are the launches' host-side plans.

Both take a graph axis, the batched engine's tile (``graphs = b``): the
``b * nv`` vertex slots of a ``graph.container.GraphUnion``, each graph's
community ids in its own slots, its ghost at its local ``nv - 1``, and
its own 2m.  The rows kernel runs the union's rows, each against its own
graph's 2m, Sigma and local community columns; Sigma's kernel is a block
a graph; the modularity takes each graph's leaf chunks and a ticket a
graph, and writes ``[b]`` values.  Each graph's outputs are the bits of
its launch alone, and ``graphs = 1`` is the single-graph launch.

``dense_half_sweep_cuda.launches`` and ``dense_modularity_cuda.launches``
count calls that launch (plain ints; one a call, though a half-sweep
launches two kernels); :func:`kernel_launches` counts the kernels
themselves.  ``noop_launch`` launches an empty kernel, the floor under any
launch's time (``chip_smoke.py`` phase 3 measures it).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_ARGS = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 3 + \
    (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
WARPS = 4               # csrc kWarps: rows in flight a block
MAX_NV = 3072           # WARPS x three [nv] rows of 4 bytes in shared
#                         memory, and Sigma's four in 48 KB
SCRATCH_WARPS = 512     # past MAX_NV: the warps of the grid, a slice each
FLAT_CHUNK = 1024       # ops.FLAT_CHUNK: values one in-order fold takes


@functools.lru_cache(maxsize=64)
def sweep_plan(nv: int, graphs: int = 1) -> dict:
    """The half-sweep's launch plan for ``graphs`` graphs of ``nv`` vertex
    slots (the kernels take it as given): the rows kernel's grid, each
    kernel's dynamic shared memory, the global scratch (floats, 0 while
    everything fits in shared memory), and the bytes of the one output
    allocation."""
    shared = nv <= MAX_NV
    grid = -(-nv * graphs // WARPS)             # a warp a row
    if not shared:
        grid = min(grid, SCRATCH_WARPS // WARPS)  # warps walk the rows
    return dict(
        grid=grid, rows_smem=3 * 4 * nv * WARPS if shared else 0,
        sigma_smem=16 * nv if shared else 0,
        scratch_floats=0 if shared else (3 * grid * WARPS + 2 * graphs) * nv,
        out_bytes=14 * nv * graphs)


@functools.lru_cache(maxsize=64)
def modularity_plan(m: int, nv: int, graphs: int = 1) -> dict:
    """The modularity's launch plan for ``graphs`` graphs of at most ``m``
    edges: the leaf chunks of each tree (a block each, in a grid row a
    graph), and the scratch: ``half`` floats a tree of each graph (twice
    its level-0 chunks at least, room for two levels), then a ticket a
    graph (integer words the launcher zeroes on the stream) and the
    ``graphs`` results."""
    n_int = max(-(-m // FLAT_CHUNK), 1)
    n_sig = max(-(-nv // FLAT_CHUNK), 1)
    half = 2 * max(n_int, n_sig)
    return dict(blocks=n_int + n_sig, n_int=n_int, n_sig=n_sig, half=half,
                scratch_floats=(2 * half + 2) * graphs)


def edge_rows(src: torch.Tensor, nv: int):
    """``(order, row_ptr)``: the edge ids stably sorted by ``src`` (so each
    row's edges keep index order) and the int32 ``[nv + 1]`` row offsets."""
    s_src, order = torch.sort(src, stable=True)
    bounds = torch.arange(nv + 1, dtype=torch.int32, device=src.device)
    row_ptr = torch.searchsorted(s_src, bounds, out_int32=True)
    return order.to(torch.int32), row_ptr


def _launch(fn, index: int, *args) -> int:
    """``fn(*args, stream)`` on card ``index`` and its current stream,
    entering the device's context only where another card is current."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(index):
        return fn(*args, stream)


def _card_index(tensors, two_m, what: str, graphs: int = 1) -> int:
    """The card all of ``tensors`` (contiguous) and ``two_m`` lie on;
    raises otherwise.  ``two_m``: float32 ``[graphs]`` (contiguous), or
    0-dim for one graph."""
    index = tensors[0].get_device()
    if index < 0 or not all(t.get_device() == index and t.is_contiguous()
                            for t in tensors):
        raise ValueError(f"the {what} takes contiguous tensors on one CUDA "
                         "device")
    if not (isinstance(two_m, torch.Tensor) and two_m.get_device() == index
            and two_m.dtype == torch.float32
            and ((graphs == 1 and two_m.dim() == 0)
                 or (two_m.shape == (graphs,) and two_m.is_contiguous()))):
        raise ValueError("two_m must be a float32 [graphs] tensor on the "
                         "card (or 0-dim for one graph)")
    return index


def sweep_outputs(nv: int, device):
    """The half-sweep's five ``[nv]`` outputs (``nv`` the slots of all its
    graphs), ``(C_new, Sigma_new, move, want, best)``, as views of one
    allocation (one split and three dtype views: fewer host operations
    than five allocations)."""
    n4 = 4 * nv
    C_new, Sigma_new, best, move, want = torch.empty(
        14 * nv, dtype=torch.bool, device=device).split((n4, n4, n4, nv, nv))
    return (C_new.view(torch.int32), Sigma_new.view(torch.float32), move,
            want, best.view(torch.float32))


def dense_half_sweep_cuda(rows, dst, w, C, K, Sigma, two_m, movable,
                          target_ok=None, anchored=True, *, graphs=1):
    """One dense half-sweep on the card: ``(C_new, Sigma_new, move, want,
    best)``, each ``[n]``, where ``best`` is a row's best candidate score
    (the plain version's ``gain`` is its sum over moved rows).  ``rows``
    is :func:`edge_rows` of the edges' sources; ``two_m`` a float32 tensor
    on the card (as the plain version divides by it), 0-dim for one graph
    or ``[graphs]``; ``movable`` and ``target_ok`` bool ``[n]``.  ``n`` is
    ``graphs * nv``: a tile's slots (see the module docstring).  The five
    outputs are views of one allocation.  Raises on anything the kernel
    does not take."""
    order, row_ptr = rows
    n = C.shape[0]
    tensors = [C, order, row_ptr, dst, w, K, Sigma, movable]
    if target_ok is not None:
        tensors.append(target_ok)
    if graphs < 1 or n % graphs:
        raise ValueError("the dense sweep takes graphs >= 1 of nv slots "
                         "each")
    nv = n // graphs
    index = _card_index(tensors, two_m, "dense sweep", graphs)
    if (order.dtype, row_ptr.dtype, dst.dtype, C.dtype) != (torch.int32,) * 4 \
            or (w.dtype, K.dtype, Sigma.dtype) != (torch.float32,) * 3 \
            or movable.dtype != torch.bool \
            or (target_ok is not None and target_ok.dtype != torch.bool):
        raise TypeError("the dense sweep takes int32 ids, float32 weights "
                        "and bool masks")
    if nv < 1 or row_ptr.shape[0] != n + 1 or K.shape[0] != n \
            or Sigma.shape[0] != n or movable.shape[0] != n \
            or (target_ok is not None and target_ok.shape[0] != n):
        raise ValueError("the dense sweep takes nv >= 1 and [n] vectors")
    plan = sweep_plan(nv, graphs)
    outs = C_new, Sigma_new, move, want, best = sweep_outputs(n, C.device)
    scratch = (torch.empty(plan["scratch_floats"], dtype=torch.float32,
                           device=C.device)
               if plan["scratch_floats"] else None)
    err = _launch(_build.bind("dense_sweep", "dense_half_sweep", _ARGS),
                  index, order.data_ptr(), row_ptr.data_ptr(),
                  dst.data_ptr(), w.data_ptr(), C.data_ptr(), K.data_ptr(),
                  Sigma.data_ptr(), two_m.data_ptr(), movable.data_ptr(),
                  None if target_ok is None else target_ok.data_ptr(),
                  int(anchored), nv, graphs, C_new.data_ptr(),
                  move.data_ptr(), want.data_ptr(), best.data_ptr(),
                  Sigma_new.data_ptr(),
                  None if scratch is None else scratch.data_ptr(),
                  plan["grid"], plan["rows_smem"], plan["sigma_smem"])
    _build.check(err, "dense_half_sweep")
    dense_half_sweep_cuda.launches += 1
    return outs


dense_half_sweep_cuda.launches = 0

_Q_ARGS = (ctypes.c_void_p,) * 7 + (ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_void_p,
                                    ctypes.c_void_p)


def dense_modularity_cuda(src, dst, w, C, Sigma, two_m, *, edge_counts=None,
                          edge_ptr=None) -> torch.Tensor:
    """The sweep loop's realized modularity (``core/local_move.py:
    realized_modularity`` without a group, its plain version) in one
    launch: the two ``ops.sum_inorder`` trees, over the masked weights and
    over Sigma^2, and ``internal / 2m - sig2 / (2m * 2m)``, the same bits.
    Returns a 0-dim float32 tensor on the card.

    For a tile (``realized_modularity_tile``), ``edge_counts`` are its
    graphs' live edges (host ints) and ``edge_ptr`` their int32 offsets
    ``[graphs + 1]`` on the card; ``C``/``Sigma`` hold ``graphs * nv``
    slots and ``two_m`` is ``[graphs]``; returns float32 ``[graphs]``,
    each graph's value the bits of its launch alone."""
    if edge_counts is None:
        graphs, m, tensors = 1, src.shape[0], (C, src, dst, w, Sigma)
    else:
        graphs, m = len(edge_counts), max(edge_counts)
        tensors = (C, src, dst, w, Sigma, edge_ptr)
        if edge_ptr.dtype != torch.int32 or \
                edge_ptr.shape[0] != graphs + 1:
            raise ValueError("edge_ptr must be int32 [graphs + 1]")
    index = _card_index(tensors, two_m, "dense modularity", graphs)
    if (src.dtype, dst.dtype, C.dtype) != (torch.int32,) * 3 \
            or (w.dtype, Sigma.dtype) != (torch.float32,) * 2:
        raise TypeError("the dense modularity takes int32 ids and float32 "
                        "weights")
    nv = C.shape[0] // graphs
    plan = modularity_plan(m, nv, graphs)
    scratch = torch.empty(plan["scratch_floats"], dtype=torch.float32,
                          device=C.device)
    q_ptr = scratch.data_ptr() + 4 * (plan["scratch_floats"] - graphs)
    err = _launch(_build.bind("dense_sweep", "dense_modularity", _Q_ARGS),
                  index, src.data_ptr(), dst.data_ptr(), w.data_ptr(),
                  C.data_ptr(), Sigma.data_ptr(), two_m.data_ptr(),
                  None if edge_counts is None else edge_ptr.data_ptr(), m,
                  nv, plan["n_int"], plan["blocks"], graphs,
                  scratch.data_ptr(), plan["half"], q_ptr)
    _build.check(err, "dense_modularity")
    dense_modularity_cuda.launches += 1
    return scratch[-1] if edge_counts is None else scratch[-graphs:]


dense_modularity_cuda.launches = 0


KERNELS = ("dense_rows", "dense_sigma", "dense_modularity_kernel")


def kernel_launches() -> dict:
    """The kernels of ``csrc/dense_sweep.cu`` launched so far in this
    process, by name (counted on the host where each launch is made)."""
    count = _build.bind("dense_sweep", "dense_kernel_launches",
                        (ctypes.c_int,), restype=ctypes.c_longlong)
    return {name: count(k) for k, name in enumerate(KERNELS)}


def noop_launch(device="cuda") -> None:
    """Launch an empty kernel on ``device``'s current stream: the floor
    under any launch's time on the card (not counted anywhere)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    _build.check(_launch(_build.bind("dense_sweep", "dense_noop_launch",
                                     (ctypes.c_void_p,)), index),
                 "dense_noop")
