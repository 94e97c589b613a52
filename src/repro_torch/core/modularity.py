"""Modularity (paper Eq. 1; port of ``repro/core/modularity.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def modularity(src, dst, w, C, nv=None) -> torch.Tensor:
    """Q = sum_c [ sigma_c / 2m - (Sigma_c / 2m)^2 ], float32[].

    Directed-COO convention: ``sigma_c`` sums directed edge weights with
    both ends in c (self-loops once), ``Sigma_c`` sums weighted degrees.
    The per-vertex sums are keyed by the sorted ``src`` (one 2-channel
    pass); the per-community sums are keyed by ``C`` and folded in index
    order through a stable sort (one more 2-channel pass).  The final flat
    sum follows torch's reduction order, not XLA's, so Q may differ from
    the reference in the last bits.
    """
    if nv is None:
        nv = C.shape[0]
    two_m = torch.sum(w)
    internal = torch.where(C[src] == C[dst], w, 0.0)
    Ks = ops.segreduce_sorted(torch.stack([w, internal], dim=1), src, nv,
                              op="sum")
    per_c = ops.segment_sum_inorder(Ks, C, nv)   # [Sigma_c, sigma_c]
    frac = per_c[:, 0] / two_m
    q = per_c[:, 1] / two_m - frac * frac
    return torch.sum(q)
