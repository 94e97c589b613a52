"""Group-optional collective wrappers (port of
``repro/distributed/collectives.py``).

Core algorithms are written once and run both on one device
(``group=None``: every collective is the identity and runs no op) and on
one rank of a process group (``core/distributed.py``).  This is the one
seam through which all graph-side communication flows: every call site
is a call of these wrappers, and :func:`all_reduce` counts the calls and
the bytes it reduces.

Each reduction runs ``torch.distributed.all_reduce`` on a copy, so the
caller's tensor is never changed, and takes only int32 and float32
tensors.  The merges the sharded driver makes are exact in any order:
integer sums and min/max, and float sums of disjoint-support vectors
(each slot is one rank's value plus zeros).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

_DTYPES = (torch.int32, torch.float32)
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def axis_size(group=None) -> int:
    """The number of ranks in ``group``; 1 without one."""
    if group is None:
        return 1
    return dist.get_world_size(group)


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """``op`` ('sum', 'min' or 'max') of ``x`` over the ranks of ``group``,
    into a new tensor.  Adds one to ``all_reduce.calls`` and the bytes of
    ``x`` to ``all_reduce.bytes``."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"collectives take int32 or float32, got {x.dtype}")
    out = x.clone()
    dist.all_reduce(out, op=_OPS[op], group=group)
    all_reduce.calls += 1
    all_reduce.bytes += out.numel() * out.element_size()
    return out


all_reduce.calls = 0
all_reduce.bytes = 0


def psum(x, group=None):
    if group is None:
        return x
    return all_reduce(x, "sum", group)


def pmin(x, group=None):
    if group is None:
        return x
    return all_reduce(x, "min", group)


def pmax(x, group=None):
    if group is None:
        return x
    return all_reduce(x, "max", group)


def all_gather(x, group=None, *, axis_index: int = 0, tiled: bool = True):
    """Every rank's ``x`` in rank order: concatenated along ``axis_index``
    (``tiled``) or stacked on a new axis there."""
    if group is None:
        return x
    if x.dtype not in _DTYPES:
        raise TypeError(f"collectives take int32 or float32, got {x.dtype}")
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return (torch.cat if tiled else torch.stack)(parts, dim=axis_index)
