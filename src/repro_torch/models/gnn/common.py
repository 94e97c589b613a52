"""Shared GNN message-passing primitives over padded edge lists (port of
``repro/models/gnn/common.py``).

Edge convention matches :mod:`repro_torch.graph.container`: directed COO
with a ghost vertex absorbing padding; per-edge masks are implied by ``src
< ghost`` and zero weights.  Features are ``[nv, D]`` with the ghost row
zeroed.  The reference's ``jax.ops.segment_sum`` / ``segment_max`` are XLA
code, not Pallas kernels, so PyTorch's own ``index_add`` and
``scatter_reduce`` serve here: the models are held to tolerances, not bits
(on the card these scatters are atomic and fold in no fixed order).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import normal


def scatter_sum(values, index, nv):
    out = torch.zeros((nv,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add(0, index.long(), values)


def scatter_max(values, index, nv, fill=-math.inf):
    out = torch.full((nv,) + tuple(values.shape[1:]), -math.inf,
                     dtype=values.dtype, device=values.device)
    idx = index.long().view((-1,) + (1,) * (values.dim() - 1))
    out = out.scatter_reduce(0, idx.expand_as(values), values, "amax",
                             include_self=True)
    return torch.where(torch.isfinite(out), out, fill)


def degree(src, nv, edge_mask=None):
    ones = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    if edge_mask is not None:
        ones = torch.where(edge_mask, ones, 0.0)
    return scatter_sum(ones, src, nv)


def sym_norm_coeff(src, dst, nv, edge_mask=None):
    """GCN symmetric normalization 1/sqrt((d_u+1)(d_v+1)) per edge."""
    d = degree(src, nv, edge_mask) + 1.0
    return torch.rsqrt(d[src.long()]) * torch.rsqrt(d[dst.long()])


def edge_softmax(scores, dst, nv, edge_mask):
    """Softmax of per-edge scores grouped by destination vertex.

    scores: [M] or [M, H]; edge_mask: bool[M].
    """
    mask = edge_mask if scores.dim() == 1 else edge_mask[:, None]
    scores = torch.where(mask, scores, -math.inf)
    mx = scatter_max(scores, dst, nv, fill=0.0)
    d = dst.long()
    ex = torch.where(mask, torch.exp(scores - mx[d]), 0.0)
    denom = scatter_sum(ex, dst, nv)
    return ex / torch.clamp(denom[d], min=1e-9)


def linear(gen: torch.Generator, d_in, d_out, scale=None, *, device=None):
    """A ``[d_in, d_out]`` float32 weight, normal with ``scale`` (default
    ``1/sqrt(d_in)``), drawn from ``gen`` on its device and placed on
    ``device`` (default: the generator's)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), device=device) * scale

