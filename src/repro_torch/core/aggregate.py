"""Aggregation phase (paper Algorithm 5), sort formulation (port of
``repro/core/aggregate.py``, ``impl='sort'``).

Relabelled edges are sorted by ``(C[src], C[dst])``; each run of equal
pairs is one super-edge whose weight is the in-order run sum.  Run r's
super-edge is written at slot r and the tail is ghost-padded, which keeps
the sort invariant and the ghost convention of the container.  Self-runs
``(c, c)`` become super-vertex self-loops carrying the community's internal
weight, so ``sum_i K_i = 2m`` holds across passes.

The reference's ``impl='dense'`` has no counterpart: it fills an
``[nv, nv]`` super-adjacency with a scatter-add, which follows edge order
on XLA's CPU backend but has no fixed order on CUDA.  Its nonzero cells,
read in flat ``(c1, c2)`` order, are the sort formulation's runs in run
order, so this function gives the dense impl's arrays bit for bit and the
dense scan calls it too.
"""
from __future__ import annotations

import torch

from repro_torch.core import _segments as seg


def aggregate(src, dst, w, C_dense):
    """Build the super-vertex graph in the same capacities.

    ``C_dense``: int32[nv] dense community ids in [0, n_comms); ghost and
    padding vertices map to an id >= n_comms that sorts last (as
    ``_segments.renumber`` guarantees).  Returns ``(src', dst', w')``.
    """
    nv = C_dense.shape[0]
    ghost = nv - 1
    m_cap = src.shape[0]

    valid = (src < ghost) & (w != 0.0)
    e_src = torch.where(valid, C_dense[src], ghost).to(torch.int32)
    e_dst = torch.where(valid, C_dense[dst], ghost).to(torch.int32)
    e_w = torch.where(valid, w, 0.0)

    s_src, s_dst, s_w = seg.sort_by_key2(e_src, e_dst, e_w)
    starts = seg.run_starts(s_src, s_dst)
    rid = seg.run_ids(starts)
    w_run = seg.runs_reduce(s_w, rid, m_cap)
    # both run fields in one 2-channel pass (integers: exact)
    ends, run_valid = seg.run_field(torch.stack([s_src, s_dst], dim=1),
                                    starts, rid, m_cap, ghost)
    src_run, dst_run = ends[:, 0], ends[:, 1]

    keep = run_valid & (src_run < ghost)
    out_src = torch.where(keep, src_run, ghost).to(torch.int32)
    out_dst = torch.where(keep, dst_run, ghost).to(torch.int32)
    out_w = torch.where(keep, w_run, 0.0)
    return out_src, out_dst, out_w


def aggregate_union(src, dst, w, C_dense, nv: int, keep_graph=None):
    """:func:`aggregate` of each graph of a tile at once, on a
    ``GraphUnion``'s live edges with ``C_dense`` from
    ``_segments.renumber_tile`` (graph ``g``'s communities in its own
    slots ``g * nv + [0, n_g)``).

    The edges :func:`aggregate` parks on the ghost (zero weight) form its
    last run, which it drops; here they are dropped before the sort, with
    the edges of every graph whose ``keep_graph`` flag (bool ``[b]`` on
    the device, or ``None`` for all) is off.  The stable sort by the union
    ids keeps each graph's super-edges in their own order, graph after
    graph, and each run folds in index order, so each graph's super-edges
    are :func:`aggregate`'s live ones, bit for bit, in its own slots.
    Returns ``(src', dst', w', counts)``, ``counts`` the super-edges of
    each graph (int64 numpy ``[b]``, one host read)."""
    b = C_dense.shape[0] // nv
    valid = (torch.remainder(src, nv) < nv - 1) & (w != 0.0)
    if keep_graph is not None:
        valid = valid & torch.index_select(
            keep_graph, 0, torch.div(src, nv, rounding_mode="floor"))
    e_src = C_dense[src[valid]]
    e_dst = C_dense[dst[valid]]
    m = e_src.shape[0]
    s_src, s_dst, s_w = seg.sort_by_key2(e_src, e_dst, w[valid])
    starts = seg.run_starts(s_src, s_dst)
    rid = seg.run_ids(starts)
    w_run = seg.runs_reduce(s_w, rid, m)
    ends, _ = seg.run_field(torch.stack([s_src, s_dst], dim=1), starts, rid,
                            m, 0)
    counts = torch.zeros(b, dtype=torch.int64, device=src.device).index_add_(
        0, torch.div(s_src, nv, rounding_mode="floor").long(),
        starts.to(torch.int64)).cpu().numpy()
    n_runs = int(counts.sum())
    return (ends[:n_runs, 0].contiguous(), ends[:n_runs, 1].contiguous(),
            w_run[:n_runs], counts)
