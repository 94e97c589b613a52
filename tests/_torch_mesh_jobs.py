"""Jobs that the port's mesh tests send to their ranks (``Mesh.run``).

A mesh pickles a job's function by import path, so the functions live in
this module, which imports nothing but torch and the port: a worker
imports it without jax.
"""
import numpy as np
import torch

from repro_torch.distributed import collectives as col
from repro_torch.graph.partition import shard_edge_ranges


def reduce_each(ctx, values, op):
    """Rank r reduces ``values[r]`` with ``op`` over the mesh; returns the
    result, whether the input stayed as it was, and the counters."""
    x = torch.from_numpy(values[ctx.rank].copy())
    before = x.clone()
    calls, nbytes = col.all_reduce.calls, col.all_reduce.bytes
    out = {"sum": col.psum, "min": col.pmin, "max": col.pmax}[op](
        x, ctx.group)
    return dict(out=out.numpy(), unchanged=torch.equal(x, before),
                same_object=out is x, calls=col.all_reduce.calls - calls,
                bytes=col.all_reduce.bytes - nbytes,
                size=col.axis_size(ctx.group))


def gather_each(ctx, values, tiled):
    """Rank r's ``values[r]`` gathered over the mesh."""
    x = torch.from_numpy(values[ctx.rank].copy())
    return col.all_gather(x, ctx.group, tiled=tiled).numpy()


def fail_on(ctx, rank):
    """Rank ``rank`` raises; the others wait in a collective for it."""
    if ctx.rank == rank:
        raise ZeroDivisionError(f"rank {rank} fails on purpose")
    col.psum(torch.ones(4, dtype=torch.int32), ctx.group)
    return ctx.rank


def where_am_i(ctx):
    return dict(rank=ctx.rank, size=ctx.size, device=str(ctx.device),
                threads=torch.get_num_threads())


def refine_shards(ctx, src, dst, w, C, two_m, tau):
    """``refine_labels`` of the live edges on this rank's shard, with the
    collectives (the split slot of the sharded driver)."""
    from repro_torch.core.louvain import refine_labels

    nv = C.shape[0]
    bounds, ranges = shard_edge_ranges(src.numpy(), nv, ctx.size)
    e0, e1 = ranges[ctx.rank]
    ids = torch.arange(nv, dtype=torch.int32)
    owned = (ids >= int(bounds[ctx.rank])) & (ids < int(bounds[ctx.rank + 1]))
    R = refine_labels(src[e0:e1], dst[e0:e1], w[e0:e1], C,
                      torch.tensor(two_m, dtype=torch.float32),
                      tau=np.float32(tau), owned=owned, group=ctx.group,
                      gidx=torch.arange(e0, e1, dtype=torch.int32),
                      m_total=src.shape[0])
    return R.numpy()
