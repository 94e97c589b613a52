"""Disconnected-community detection (paper Algorithm 6, adapted; port of
``repro/core/detect.py``).

The split fixpoint labels each (community ∩ connected component); a
community holding more than one distinct label is internally disconnected.
"""
from __future__ import annotations

import torch

from repro_torch.core import _segments as seg
from repro_torch.core.split import split_labels
from repro_torch.kernels import ops


def disconnected_communities(src, dst, w, C, n_nodes) -> dict:
    """Flags and counts of internally-disconnected communities.

    Returns a dict with ``disconnected`` (bool[nv] per community id),
    ``n_disconnected`` and ``n_communities`` (int32[]) and ``fraction``
    (float32[]).
    """
    nv = C.shape[0]
    ghost = nv - 1
    node_valid = torch.arange(nv, device=C.device) < n_nodes

    L, _ = split_labels(src, dst, w, C, mode="pj")
    # count distinct (C, L) pairs per community: sort pairs, count run starts
    c_key = torch.where(node_valid, C, ghost).to(torch.int32)
    l_key = torch.where(node_valid, L, ghost).to(torch.int32)
    s_c, s_l, _ = seg.sort_runs(c_key, l_key)
    starts = seg.run_starts(s_c, s_l)
    pieces = ops.segreduce_sorted(
        (starts & (s_c < ghost)).to(torch.int32), s_c, nv, op="sum")
    disconnected = pieces > 1
    n_disc = torch.sum(disconnected).to(torch.int32)
    n_comms = seg.count_communities(C, node_valid, nv)
    frac = n_disc / torch.clamp(n_comms, min=1)
    return dict(
        disconnected=disconnected,
        n_disconnected=n_disc,
        n_communities=n_comms,
        fraction=frac.to(torch.float32),
    )
