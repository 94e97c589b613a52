"""Aggregation phase (paper Algorithm 5), sort formulation (port of
``repro/core/aggregate.py``, ``impl='sort'``).

Relabelled edges are sorted by ``(C[src], C[dst])``; each run of equal
pairs is one super-edge whose weight is the in-order run sum.  Run r's
super-edge is written at slot r and the tail is ghost-padded, which keeps
the sort invariant and the ghost convention of the container.  Self-runs
``(c, c)`` become super-vertex self-loops carrying the community's internal
weight, so ``sum_i K_i = 2m`` holds across passes.
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
