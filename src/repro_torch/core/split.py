"""Splitting phase: partition internally-disconnected communities (port of
``repro/core/split.py``, both impls).

* ``lp``  — minimum-label Label Propagation (paper Alg. 1, LP).
* ``lpp`` — LP with Pruning (paper Alg. 1, LPP).
* ``pj``  — pointer-jumping: min-label propagation plus label shortcutting
  ``L <- L[L]`` each round, O(log diameter) rounds (the reference's
  accelerator-native filler for the paper's per-thread BFS).

All variants reach the same fixpoint: ``L[i]`` = min vertex id within
(community of i) ∩ (connected component of i restricted to it).  Label math
is integer min/max, so every formulation is exact.  The ``lax.while_loop``
is a Python loop driven from the host, which reads one flag per round.

``impl='coo'`` reduces over the edges with the segment-reduce kernel;
``impl='dense'`` (the dense scan's) holds the same-community adjacency as a
bool[nv, nv] matrix and takes a row min a round; :func:`split_labels_tile`
runs it for the graphs of the engine's tile at once, ``[b, nv, nv]``.
"""
from __future__ import annotations

import torch

from repro_torch.core._segments import INT_MAX
from repro_torch.distributed import collectives as col
from repro_torch.kernels import ops

MODES = ("lp", "lpp", "pj")
IMPLS = ("coo", "dense")


def _same_community_adjacency(src, dst, C, adj=None) -> torch.Tensor:
    """bool[nv, nv]: the dense impl's same-community adjacency between
    real vertices, masked from the caller's edge adjacency ``adj`` or
    assigned from the edges (``True`` only, no accumulation: exact in any
    order).  With ``adj`` given, ``C [..., nv]`` and ``adj [..., nv, nv]``
    may carry leading (graph) axes."""
    nv = C.shape[-1]
    ghost = nv - 1
    ids = torch.arange(nv, dtype=torch.int32, device=C.device)
    if adj is not None:
        return (adj & (C[..., :, None] == C[..., None, :])
                & (ids[:, None] < ghost) & (ids[None, :] < ghost))
    same = (C[src] == C[dst]) & (src < ghost) & (dst < ghost)
    # edges outside a community land on (ghost, ghost), cleared after
    A_same = torch.zeros((nv, nv), dtype=torch.bool, device=C.device)
    A_same[torch.where(same, src, ghost).long(),
           torch.where(same, dst, ghost).long()] = True
    A_same[ghost, ghost] = False
    return A_same


def split_labels(src, dst, w, C, *, mode: str = "pj", max_iters: int = 0,
                 impl: str = "coo", adj=None, group=None):
    """Label every vertex with its (component ∩ community) representative.

    Args:
      src, dst, w: padded directed COO, ``src`` sorted (``w`` is unused and
        kept for call-site parity with the reference).
      C: int32[nv] community membership.
      mode: 'lp' | 'lpp' | 'pj'.
      max_iters: 0 = run to the fixpoint, bounded by nv rounds.
      impl: 'coo' | 'dense' (see the module docstring).
      adj: the dense impl's bool[nv, nv] edge adjacency, shared by the
        caller, or ``None`` to assign it from the edges.
      group: on a rank of this process group (the sharded driver), the
        edges are this shard's, every out-edge of a vertex on one shard:
        the per-round candidate takes a ``pmin``, the wake-up and
        ``changed`` a ``pmax``, and every rank returns the single-device
        labels.  ``None``: no collective.  The dense impl is single-device
        only.

    Returns:
      (labels int32[nv], rounds as a Python int).  ``labels`` refines ``C``.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "dense" and group is not None:
        raise ValueError("impl='dense' is single-device only (group=None)")
    nv = C.shape[0]
    ghost = nv - 1
    limit = max_iters if max_iters > 0 else nv
    if impl == "dense":
        # C is fixed for the whole fixpoint: the masked adjacency is too
        return _dense_fixpoint(_same_community_adjacency(src, dst, C, adj),
                               mode, limit)
    same = (C[src] == C[dst]) & (src < ghost) & (dst < ghost)
    L = torch.arange(nv, dtype=torch.int32, device=C.device)
    active = torch.ones(nv, dtype=torch.bool, device=C.device)
    changed, it = True, 0
    while changed and it < limit:
        # candidate: min label over same-community neighbours, keyed by the
        # sorted src (the symmetric COO makes in- and out-neighbours equal)
        cand = col.pmin(ops.segreduce_sorted(
            torch.where(same, L[dst], INT_MAX), src, nv, op="min"), group)
        L_new = torch.minimum(L, cand)
        if mode == "lpp":
            # pruned vertices are not recomputed this round (paper line 8)
            L_new = torch.where(active, L_new, L)
        if mode == "pj":
            L_new = L_new[L_new]  # pointer jumping (label shortcutting)
            L_new = L_new[L_new]
        moved = L_new != L
        if mode == "lpp":
            # wake same-community neighbours of changed vertices
            nbr = col.pmax(ops.segreduce_sorted(
                (moved[dst] & same).to(torch.int32), src, nv,
                op="max"), group) > 0
            active = nbr | moved
        if group is None:
            changed = bool(moved.any())
        else:
            changed = bool(col.pmax(moved.any().to(torch.int32)[None],
                                    group) > 0)
        L = L_new
        it += 1
    return L, it


def _dense_fixpoint(A_same, mode: str, limit: int):
    """The dense impl's rounds on ``A_same [..., nv, nv]``: ``(labels
    int32 [..., nv], rounds)``, a row min a round.  Leading axes are
    graphs that run their rounds together: a graph at its fixpoint maps
    to itself (``L_new == L``), so the extra rounds of a tile's earlier
    graphs change nothing, and the integer labels are each graph's own."""
    nv = A_same.shape[-1]
    L = torch.arange(nv, dtype=torch.int32, device=A_same.device).expand(
        A_same.shape[:-1]).contiguous()
    active = torch.ones_like(L, dtype=torch.bool)
    changed, it = True, 0
    while changed and it < limit:
        cand = torch.amin(torch.where(A_same, L[..., None, :], INT_MAX),
                          dim=-1)
        L_new = torch.minimum(L, cand)
        if mode == "lpp":
            L_new = torch.where(active, L_new, L)
        if mode == "pj":
            L_new = torch.gather(L_new, -1, L_new.long())
            L_new = torch.gather(L_new, -1, L_new.long())
        moved = L_new != L
        if mode == "lpp":
            active = torch.any(A_same & moved[..., :, None], dim=-2) | moved
        changed = bool(moved.any())
        L = L_new
        it += 1
    return L, it


def split_labels_tile(C, adj, *, mode: str = "pj", max_iters: int = 0):
    """:func:`split_labels` with the dense impl for each graph of a tile:
    ``C`` int32 ``[b, nv]`` (local ids), ``adj`` bool ``[b, nv, nv]``
    (``core/local_move.py:tile_adjacency``).  Returns the local labels
    ``[b, nv]``, each graph's :func:`split_labels` labels."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    nv = C.shape[-1]
    limit = max_iters if max_iters > 0 else nv
    L, _ = _dense_fixpoint(_same_community_adjacency(None, None, C, adj),
                           mode, limit)
    return L
