"""DTensor sharding rules the port's steps need (``register_sharding``).

DTensor propagates shardings op by op; an op without a strategy raises.
:func:`register` gives one to each op the step builder's cells reach that
DTensor (as of PyTorch 2.11-2.13) lacks, and to the flash-attention op
(:mod:`repro_torch.kernels.flash_attn`).  Every rule offers the
all-replicated strategy, so at worst DTensor gathers the inputs (and the
trace counts those all-gathers); where an op works along one dim, it
also offers every input and output sharded alike on another dim (the batch
dim of the LM's per-row MoE dispatch), which keeps such ops shard-local.

:func:`write_slot` is the one in-place write DTensor cannot place: a
slot of a dim it shards (the decode cache's length).
"""
from __future__ import annotations

import torch

_DONE = False


def _alike(ndim: int, work_dims, n_tensor_args: int, n_out: int,
           extra_args: int = 0):
    """Strategies: all replicated, then all sharded on each dim not in
    ``work_dims`` (each of ``n_out`` outputs and ``n_tensor_args`` tensor
    args alike; ``extra_args`` non-tensor args get ``None``)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [([Replicate()] * n_out,
            [Replicate()] * n_tensor_args + [None] * extra_args)]
    for d in range(ndim):
        if d in work_dims:
            continue
        out.append(([Shard(d)] * n_out,
                    [Shard(d)] * n_tensor_args + [None] * extra_args))
    return out


def register() -> None:
    """Register the rules (once a process)."""
    global _DONE
    if _DONE:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    from repro_torch.kernels import flash_attn  # noqa: F401 (the op)

    aten = torch.ops.aten

    @register_sharding(torch.ops.repro_torch.flash_attention.default)
    def _flash(q, k, v, causal, window):
        # batch-sharded always; head-sharded where Hq and Hkv split alike
        # (each shard's query heads then find their kv heads locally)
        rules = [([Replicate()], [Replicate()] * 3 + [None, None]),
                 ([Shard(0)], [Shard(0)] * 3 + [None, None])]
        sizes = q.mesh.shape
        if all(k.shape[2] % n == 0 for n in sizes):
            rules.append(([Shard(2)], [Shard(2)] * 3 + [None, None]))
        return rules

    @register_sharding(aten.sort.stable)
    def _sort(x, *, stable=None, dim=-1, descending=False):
        d = dim % x.ndim
        return _alike(x.ndim, {d}, 1, 2)

    @register_sharding(aten.searchsorted.Tensor)
    def _searchsorted(seq, x, *, out_int32=False, right=False, side=None,
                      sorter=None):
        if seq.ndim == 1:
            return [([Replicate()], [Replicate(), Replicate()])]
        return _alike(seq.ndim, {seq.ndim - 1}, 2, 1)

    @register_sharding(aten.scatter_reduce.two)
    def _scatter_reduce(x, dim, index, src, reduce, *, include_self=True):
        d0 = dim % x.ndim
        rules = [([Replicate()], [Replicate(), None, Replicate(), Replicate(),
                                  None])]
        for d in range(x.ndim):
            if d != d0:
                rules.append(([Shard(d)], [Shard(d), None, Shard(d),
                                           Shard(d), None]))
        return rules

    _DONE = True


def write_slot(buf, dim: int, index: int, val) -> None:
    """``buf.select(dim, index)[...] = val`` for a DTensor ``buf``: the rank
    whose local shard of ``buf`` holds ``index`` writes the slot there, at
    its local offset; no other rank writes (a sharded dynamic-update-slice,
    whose traffic is the slot's bytes).  ``val``: a number, or a tensor of
    ``buf``'s shape less ``dim`` (a DTensor is first redistributed to
    ``buf``'s placements on the other dims, a collective every rank joins).
    DTensor itself cannot select a slot of a sharded dim in place."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = buf.device_mesh
    lo, size = 0, buf.shape[dim]       # this rank's range along dim
    for p, n, c in zip(buf.placements, mesh.shape, mesh.get_coordinate()):
        if p.is_shard() and p.dim == dim:
            if type(p) is not Shard:
                raise NotImplementedError(f"write_slot along {p}")
            chunk = -(-size // n)          # DTensor's even split
            start = min(c * chunk, size)
            lo, size = lo + start, min(chunk, size - start)
    if isinstance(val, DTensor):
        placements = [
            Shard(p.dim - (p.dim > dim)) if p.is_shard() and p.dim != dim
            else Replicate() for p in buf.placements]
        val = val.redistribute(mesh, placements).to_local()
    i = index - lo
    if 0 <= i < size:
        slot = buf.to_local().select(dim, i)
        if isinstance(val, torch.Tensor):
            slot.copy_(val)
        else:
            slot.fill_(val)
