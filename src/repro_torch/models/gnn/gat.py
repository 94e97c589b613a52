"""GAT (Velickovic et al., arXiv:1710.10903): SDDMM edge scores ->
segment-softmax -> weighted scatter (port of ``repro/models/gnn/gat.py``).
gat-cora: 2 layers, 8 hidden, 8 heads.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models import normal
from repro_torch.models.gnn import common


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    negative_slope: float = 0.2


def init_gat(gen: torch.Generator, cfg: GATConfig, *, device=None):
    layers = []
    d_in = cfg.d_in
    for li in range(cfg.n_layers):
        last = li == cfg.n_layers - 1
        h = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        layers.append(dict(
            w=common.linear(gen, d_in, h * d_out, device=device),
            a_src=normal(gen, (h, d_out), device=device) * 0.1,
            a_dst=normal(gen, (h, d_out), device=device) * 0.1,
        ))
        d_in = h * d_out if not last else d_out
    return dict(layers=layers)


def param_logical_axes(cfg: GATConfig):
    return dict(layers=[
        dict(w=("fsdp", "heads"), a_src=("heads", None), a_dst=("heads", None))
        for _ in range(cfg.n_layers)
    ])


def gat_forward(params, x, src, dst, cfg: GATConfig, edge_mask=None):
    nv = x.shape[0]
    if edge_mask is None:
        edge_mask = src < (nv - 1)
    s, d = src.long(), dst.long()
    h = x
    n_layers = len(params["layers"])
    for li, lp in enumerate(params["layers"]):
        last = li == n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = lp["w"].shape[1] // heads
        z = (h @ lp["w"]).reshape(nv, heads, d_out)
        e_src = torch.einsum("nhd,hd->nh", z, lp["a_src"])
        e_dst = torch.einsum("nhd,hd->nh", z, lp["a_dst"])
        scores = F.leaky_relu(e_src[s] + e_dst[d], cfg.negative_slope)
        alpha = common.edge_softmax(scores, dst, nv, edge_mask)   # [M, H]
        msg = z[s] * alpha[..., None]                             # [M, H, D]
        agg = common.scatter_sum(msg, dst, nv)                    # [nv, H, D]
        if last:
            h = agg[:, 0]
        else:
            h = F.elu(agg.reshape(nv, heads * d_out))
    return h
