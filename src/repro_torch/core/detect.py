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


def disconnected_communities(src, dst, w, C, n_nodes, *, impl: str = "coo",
                             adj=None) -> dict:
    """Flags and counts of internally-disconnected communities.

    ``impl`` picks the split fixpoint's formulation ('coo' | 'dense', see
    :func:`repro_torch.core.split.split_labels`); ``adj`` shares the dense
    scan's bool[nv, nv] adjacency with it.

    Returns a dict with ``disconnected`` (bool[nv] per community id),
    ``n_disconnected`` and ``n_communities`` (int32[]) and ``fraction``
    (float32[]).
    """
    nv = C.shape[0]
    ghost = nv - 1
    node_valid = torch.arange(nv, device=C.device) < n_nodes

    L, _ = split_labels(src, dst, w, C, mode="pj", impl=impl, adj=adj)
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


def disconnected_communities_tile(src, dst, w, C, node_valid,
                                  graphs: int) -> dict:
    """:func:`disconnected_communities` of each graph of a tile, on a
    ``GraphUnion``'s live edges: ``C`` and ``node_valid`` ``[b * nv]`` in
    its slots (communities in their own graph's slots).

    The coo split runs on the union as on one graph of ``b * nv`` slots:
    no live edge touches a ghost and no edge crosses graphs, so each
    graph's labels are its own plus ``g * nv`` (integer fixpoints).  The
    ``(C, L)`` runs are counted per community as there, and per graph by
    an integer sum.  Returns ``n_disconnected`` and ``n_communities``
    (int32 ``[b]``) and ``fraction`` (float32 ``[b]``)."""
    n = C.shape[0]
    nv = n // graphs
    slot = torch.arange(n, dtype=torch.int32, device=C.device)
    ghost_of = slot - torch.remainder(slot, nv) + (nv - 1)
    L, _ = split_labels(src, dst, w, C, mode="pj")
    c_key = torch.where(node_valid, C, ghost_of).to(torch.int32)
    l_key = torch.where(node_valid, L, ghost_of).to(torch.int32)
    s_c, s_l, _ = seg.sort_runs(c_key, l_key)
    starts = seg.run_starts(s_c, s_l)
    is_ghost = torch.remainder(s_c, nv) == nv - 1
    pieces = ops.segreduce_sorted((starts & ~is_ghost).to(torch.int32), s_c,
                                  n, op="sum")
    n_disc = torch.sum((pieces > 1).view(graphs, nv), dim=1).to(torch.int32)
    n_comms = seg.count_communities_tile(C, node_valid, graphs)
    frac = n_disc / torch.clamp(n_comms, min=1)
    return dict(n_disconnected=n_disc, n_communities=n_comms,
                fraction=frac.to(torch.float32))
