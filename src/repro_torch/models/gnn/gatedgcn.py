"""GatedGCN (Bresson & Laurent via Dwivedi et al., arXiv:2003.00982), port
of ``repro/models/gnn/gatedgcn.py``.

Edge-featured MPNN with gated aggregation:
    e'_ij = A h_i + B h_j + C e_ij ;  sigma_ij = sigmoid(e'_ij)
    h'_i  = h_i + ReLU(LN(U h_i + sum_j sigma_ij (.) V h_j / (sum sigma + eps)))
(benchmark configuration: 16 layers, 70 hidden, residual; layernorm stands
in for batch norm, as in the reference).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn import common


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str = "gatedgcn"
    n_layers: int = 16
    d_in: int = 32
    d_hidden: int = 70
    n_classes: int = 6


def init_gatedgcn(gen: torch.Generator, cfg: GatedGCNConfig, *,
                  device=None):
    d = cfg.d_hidden
    dev = device if device is not None else gen.device

    def lin(a, b):
        return common.linear(gen, a, b, device=device)

    layers = [dict(A=lin(d, d), B=lin(d, d), C=lin(d, d), U=lin(d, d),
                   V=lin(d, d),
                   ln_h=torch.ones((d,), dtype=torch.float32, device=dev),
                   ln_e=torch.ones((d,), dtype=torch.float32, device=dev))
              for _ in range(cfg.n_layers)]
    return dict(embed_h=lin(cfg.d_in, d), embed_e=lin(1, d),
                head=lin(d, cfg.n_classes), layers=layers)


def param_logical_axes(cfg: GatedGCNConfig):
    lx = dict(A=("fsdp", "feat"), B=("fsdp", "feat"), C=("fsdp", "feat"),
              U=("fsdp", "feat"), V=("fsdp", "feat"),
              ln_h=(None,), ln_e=(None,))
    return dict(
        embed_h=("fsdp", "feat"), embed_e=(None, "feat"),
        head=("feat", None), layers=[lx] * cfg.n_layers,
    )


def _ln(x, g, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g


def gatedgcn_forward(params, x, src, dst, w, cfg: GatedGCNConfig,
                     edge_mask=None):
    """x: [nv, d_in]; w: f32[M] edge weights used as scalar edge features."""
    nv = x.shape[0]
    if edge_mask is None:
        edge_mask = src < (nv - 1)
    s, d = src.long(), dst.long()
    h = x @ params["embed_h"]
    e = w[:, None] @ params["embed_e"]                  # [M, D]
    for lp in params["layers"]:
        eh = h[s] @ lp["A"] + h[d] @ lp["B"] + e @ lp["C"]
        gate = torch.sigmoid(eh)
        gate = torch.where(edge_mask[:, None], gate, 0.0)
        num = common.scatter_sum(gate * (h[s] @ lp["V"]), dst, nv)
        den = common.scatter_sum(gate, dst, nv)
        agg = h @ lp["U"] + num / (den + 1e-6)
        h = h + torch.relu(_ln(agg, lp["ln_h"]))
        e = e + torch.relu(_ln(eh, lp["ln_e"]))
    return h @ params["head"]
