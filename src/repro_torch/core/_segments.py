"""Run-detection and renumbering primitives (port of
``repro/core/_segments.py``).

After sorting edge records by a composite key, equal keys form contiguous
*runs*; a run is one entry of the paper's per-thread hashtable
(scanCommunities, Alg. 4).  Runs are indexed by their position in
``[0, m_cap)`` and unused run slots are masked.  Every run reduction goes
through :func:`repro_torch.kernels.ops.segreduce_sorted`.

``lax.sort(..., num_keys=2, is_stable=True)`` becomes one stable
``torch.sort`` of the packed int64 key ``(k1 << 32) | k2``: keys are
non-negative ids below ``nv``, so the packed order is the lexicographic
order, and ties keep ascending index order as in the reference.  Integer
reductions that torch widens to int64 (``cumsum``, ``sum``) are cast back
to int32 so keys and the ``INT_MAX`` sentinel keep their meaning.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

INT_MAX = 2**31 - 1


def sort_runs(k1: torch.Tensor, k2: torch.Tensor):
    """Stable sort by (k1, k2) carrying only a permutation payload.

    Returns ``(s_k1, s_k2, perm)``, all int32.  Keys must lie in
    ``[0, 2**31)``."""
    key = (k1.to(torch.int64) << 32) | k2.to(torch.int64)
    s_key, perm = torch.sort(key, stable=True)
    return ((s_key >> 32).to(torch.int32),
            (s_key & 0xFFFFFFFF).to(torch.int32),
            perm.to(torch.int32))


def sort_by_key2(k1: torch.Tensor, k2: torch.Tensor, *values):
    """Stable sort of values by the composite key (k1, k2)."""
    s_k1, s_k2, perm = sort_runs(k1, k2)
    return (s_k1, s_k2) + tuple(v[perm] for v in values)


def run_starts(*sorted_keys: torch.Tensor) -> torch.Tensor:
    """Boolean flags marking the first element of each (k1, k2, ...) run."""
    m = sorted_keys[0].shape[0]
    flags = torch.ones(m, dtype=torch.bool, device=sorted_keys[0].device)
    if m > 1:
        neq = sorted_keys[0][1:] != sorted_keys[0][:-1]
        for k in sorted_keys[1:]:
            neq = neq | (k[1:] != k[:-1])
        flags[1:] = neq
    return flags


def run_ids(starts: torch.Tensor) -> torch.Tensor:
    """Run index per element, int32[m]; monotone, starts at 0."""
    return (torch.cumsum(starts.to(torch.int32), 0) - 1).to(torch.int32)


def runs_reduce(sorted_w: torch.Tensor, rid: torch.Tensor, m_cap: int, *,
                op: str = "sum") -> torch.Tensor:
    """Reduce values within each run -> [m_cap] indexed by run id."""
    return ops.segreduce_sorted(sorted_w, rid, m_cap, op=op)


def run_field(sorted_x: torch.Tensor, starts: torch.Tensor,
              rid: torch.Tensor, m_cap: int, fill):
    """First element of each run for a sorted field ``[m]`` or ``[m, D]``;
    ``fill`` in unused run slots.  Returns ``(field, valid)``."""
    mask = starts if sorted_x.dim() == 1 else starts[:, None]
    out = ops.segreduce_sorted(torch.where(mask, sorted_x, 0), rid, m_cap,
                               op="sum")
    valid = torch.arange(m_cap, device=rid.device) < torch.count_nonzero(
        starts)
    vmask = valid if sorted_x.dim() == 1 else valid[:, None]
    return torch.where(vmask, out, fill), valid


def renumber(labels: torch.Tensor, node_valid: torch.Tensor, nv: int):
    """Dense renumbering of labels in [0, nv) (labels ARE vertex ids).

    Labels of invalid vertices collapse into the ghost group (nv - 1).  A
    presence bitmap and its exclusive prefix sum assign ranks in label
    order.  Returns ``(dense int32[nv], n_communities int32[])``: valid
    communities get [0, n_communities); the ghost group maps to
    n_communities.
    """
    ghost = nv - 1
    lab = torch.where(node_valid, labels, ghost).to(torch.int32)
    present = torch.zeros(nv, dtype=torch.int32, device=labels.device)
    present[lab] = 1
    rank = (torch.cumsum(present, 0) - present).to(torch.int32)
    return rank[lab], rank[ghost]


def count_communities(C: torch.Tensor, node_valid: torch.Tensor,
                      nv: int) -> torch.Tensor:
    """Number of distinct community ids among valid vertices."""
    _, n = renumber(C, node_valid, nv)
    return n


def renumber_tile(labels: torch.Tensor, node_valid: torch.Tensor,
                  graphs: int):
    """:func:`renumber` of each graph of a tile at once: ``labels`` and
    ``node_valid`` ``[b * nv]`` in a ``GraphUnion``'s slots (labels in
    their own graph's slots).  One presence bitmap and one exclusive
    prefix sum over the union; each graph's ranks are the union's less
    the rank at its first slot, so ids stay graph-major.  Returns
    ``(dense int32 [b * nv] in union slots, n_communities int32 [b])``:
    graph ``g``'s valid communities get ``g * nv + [0, n_g)``, and its
    ghost group (left out of ``n_g``) ``g * nv + n_g``."""
    n = labels.shape[0]
    nv = n // graphs
    slot = torch.arange(n, dtype=torch.int32, device=labels.device)
    base = slot - torch.remainder(slot, nv)
    lab = torch.where(node_valid, labels, base + (nv - 1)).to(torch.int32)
    present = torch.zeros(n, dtype=torch.int32, device=labels.device)
    present[lab] = 1
    rank = (torch.cumsum(present, 0) - present).to(torch.int32)
    first = rank[::nv]
    dense = rank[lab] - torch.repeat_interleave(first, nv) + base
    return dense, rank[nv - 1::nv] - first


def count_communities_tile(C: torch.Tensor, node_valid: torch.Tensor,
                           graphs: int) -> torch.Tensor:
    """int32 ``[b]``: :func:`count_communities` of each graph of a tile."""
    return renumber_tile(C, node_valid, graphs)[1]
