"""Splitting phase: partition internally-disconnected communities (port of
``repro/core/split.py``, the ``coo`` impl).

* ``lp``  — minimum-label Label Propagation (paper Alg. 1, LP).
* ``lpp`` — LP with Pruning (paper Alg. 1, LPP).
* ``pj``  — pointer-jumping: min-label propagation plus label shortcutting
  ``L <- L[L]`` each round, O(log diameter) rounds (the reference's
  accelerator-native filler for the paper's per-thread BFS).

All variants reach the same fixpoint: ``L[i]`` = min vertex id within
(community of i) ∩ (connected component of i restricted to it).  Label math
is integer min/max, so every formulation is exact.  The ``lax.while_loop``
is a Python loop driven from the host, which reads one flag per round.
"""
from __future__ import annotations

import torch

from repro_torch.core._segments import INT_MAX
from repro_torch.kernels import ops

MODES = ("lp", "lpp", "pj")


def split_labels(src, dst, w, C, *, mode: str = "pj", max_iters: int = 0):
    """Label every vertex with its (component ∩ community) representative.

    Args:
      src, dst, w: padded directed COO, ``src`` sorted (``w`` is unused and
        kept for call-site parity with the reference).
      C: int32[nv] community membership.
      mode: 'lp' | 'lpp' | 'pj'.
      max_iters: 0 = run to the fixpoint, bounded by nv rounds.

    Returns:
      (labels int32[nv], rounds as a Python int).  ``labels`` refines ``C``.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    nv = C.shape[0]
    ghost = nv - 1
    limit = max_iters if max_iters > 0 else nv
    same = (C[src] == C[dst]) & (src < ghost) & (dst < ghost)
    L = torch.arange(nv, dtype=torch.int32, device=C.device)
    active = torch.ones(nv, dtype=torch.bool, device=C.device)
    changed, it = True, 0
    while changed and it < limit:
        # candidate: min label over same-community neighbours, keyed by the
        # sorted src (the symmetric COO makes in- and out-neighbours equal)
        cand = ops.segreduce_sorted(torch.where(same, L[dst], INT_MAX), src,
                                    nv, op="min")
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
            nbr = ops.segreduce_sorted((moved[dst] & same).to(torch.int32),
                                       src, nv, op="max") > 0
            active = nbr | moved
        changed = bool(moved.any())
        L = L_new
        it += 1
    return L, it
