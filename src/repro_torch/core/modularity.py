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
    order through a stable sort (one more 2-channel pass).  2m and the
    final flat sum over communities are ``ops.sum_inorder`` folds, so Q has
    the same bits on the card and on the CPU: the max-quality tier decides
    between its two candidates by it.  The reference's ``jnp.sum`` folds in
    another order, so Q may differ from it in the last bits.
    """
    if nv is None:
        nv = C.shape[0]
    two_m = ops.sum_inorder(w)
    internal = torch.where(C[src] == C[dst], w, 0.0)
    Ks = ops.segreduce_sorted(torch.stack([w, internal], dim=1), src, nv,
                              op="sum")
    per_c = ops.segment_sum_inorder(Ks, C, nv)   # [Sigma_c, sigma_c]
    frac = per_c[:, 0] / two_m
    q = per_c[:, 1] / two_m - frac * frac
    return ops.sum_inorder(q)


def modularity_tile(src, dst, w, C, counts) -> torch.Tensor:
    """:func:`modularity` of each graph of a tile, float32 ``[b]``, on a
    ``GraphUnion``'s live edges (``counts`` its per-graph edges, host
    ints) and ``C [b * nv]`` in its slots: the same two 2-channel passes
    over the union (segments never cross graphs), each graph's 2m and
    final flat sum by ``ops.sum_inorder_per_graph``, so each value is the
    bits of :func:`modularity` on its graph alone."""
    b = len(counts)
    n = C.shape[0]
    nv = n // b
    two_m = ops.sum_inorder_per_graph(w, counts)
    internal = torch.where(C[src] == C[dst], w, 0.0)
    Ks = ops.segreduce_sorted(torch.stack([w, internal], dim=1), src, n,
                              op="sum")
    per_c = ops.segment_sum_inorder(Ks, C, n)   # [Sigma_c, sigma_c]
    two_m_c = torch.repeat_interleave(two_m, nv)
    frac = per_c[:, 0] / two_m_c
    q = per_c[:, 1] / two_m_c - frac * frac
    return ops.sum_inorder_per_graph(q, (nv,) * b)
