"""GCN (Kipf & Welling, arXiv:1609.02907): Ahat X W via edge scatter (port
of ``repro/models/gnn/gcn.py``).

``Ahat = D^-1/2 (A + I) D^-1/2`` is applied as per-edge coefficients plus a
self-term — no sparse matrix is materialized.  ``norm='mean'`` swaps
symmetric normalization for mean aggregation.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.gnn import common


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    norm: str = "sym"          # sym | mean
    dropout: float = 0.0


def init_gcn(gen: torch.Generator, cfg: GCNConfig, *, device=None):
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    dev = device if device is not None else gen.device
    return dict(
        w=[common.linear(gen, dims[i], dims[i + 1], device=device)
           for i in range(len(dims) - 1)],
        b=[torch.zeros((dims[i + 1],), dtype=torch.float32, device=dev)
           for i in range(len(dims) - 1)],
    )


def param_logical_axes(cfg: GCNConfig):
    n = cfg.n_layers
    return dict(w=[("fsdp", "feat")] * n, b=[(None,)] * n)


def gcn_forward(params, x, src, dst, cfg: GCNConfig, edge_mask=None):
    """x: [nv, d_in] node features (ghost row zero) -> logits [nv, C]."""
    nv = x.shape[0]
    if edge_mask is None:
        edge_mask = src < (nv - 1)
    if cfg.norm == "sym":
        coeff = common.sym_norm_coeff(src, dst, nv, edge_mask)
        self_c = 1.0 / (common.degree(src, nv, edge_mask) + 1.0)
    else:
        deg = torch.clamp(common.degree(dst, nv, edge_mask), min=1.0)
        coeff = 1.0 / deg[dst.long()]
    coeff = torch.where(edge_mask, coeff, 0.0)

    h = x
    s = src.long()
    for li, (w, b) in enumerate(zip(params["w"], params["b"])):
        h = h @ w + b
        msg = h[s] * coeff[:, None]
        agg = common.scatter_sum(msg, dst, nv)
        if cfg.norm == "sym":   # 'mean' averages the in-neighbours only
            agg = agg + h * self_c[:, None]
        h = agg
        if li < len(params["w"]) - 1:
            h = torch.relu(h)
    return h
