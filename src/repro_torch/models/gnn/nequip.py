"""NequIP (Batzner et al., arXiv:2101.03164): E(3)-equivariant interatomic
potential with channel-wise ("uvu") Clebsch-Gordan tensor-product messages
(port of ``repro/models/gnn/nequip.py``).

Node state: one feature block per irrep degree l in {0..l_max}:
``h[l]: [nv, C, 2l+1]``.  Message for path (l1, l2 -> l3):

    m3[e] = R_path(|r_e|) * einsum('ci,j,ijk->ck', h[l1][src_e], sh_l2(r_e), CG)

summed over paths into each l3, scatter-summed over edges, then mixed by a
per-l self-interaction linear layer and a gate nonlinearity (scalars gate
the norms of l > 0 blocks).  Radial weights come from a Bessel-RBF + cutoff
envelope MLP, one output per (path, channel).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models import normal
from repro_torch.models.gnn import common
from repro_torch.models.gnn.irreps import admissible_paths, clebsch_gordan, sh


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32           # channels per irrep degree
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    radial_hidden: int = 16


def init_nequip(gen: torch.Generator, cfg: NequIPConfig, *, device=None):
    C = cfg.d_hidden
    n_paths = len(admissible_paths(cfg.l_max))

    def lin(a, b):
        return common.linear(gen, a, b, device=device)

    layers = [dict(
        radial=dict(w1=lin(cfg.n_rbf, cfg.radial_hidden),
                    w2=lin(cfg.radial_hidden, n_paths * C)),
        self_int={str(l): lin(C, C) for l in range(cfg.l_max + 1)},
        gates=lin(C, cfg.l_max * C),
    ) for _ in range(cfg.n_layers)]
    return dict(
        species_embed=normal(gen, (cfg.n_species, C),
                                    device=device) * 0.5,
        layers=layers,
        readout=lin(C, 1),
    )


def param_logical_axes(cfg: NequIPConfig):
    layer = dict(
        radial=dict(w1=(None, None), w2=(None, "feat")),
        self_int={str(l): ("feat", None) for l in range(cfg.l_max + 1)},
        gates=("feat", None),
    )
    return dict(
        species_embed=(None, "feat"),
        layers=[layer] * cfg.n_layers,
        readout=("feat", None),
    )


def bessel_rbf(r, n_rbf, cutoff):
    """Bessel radial basis with smooth polynomial cutoff envelope."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    basis = math.sqrt(2.0 / cutoff) * torch.sin(
        n[None, :] * math.pi * r[:, None] / cutoff
    ) / r[:, None]
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 10.0 * x**3 + 15.0 * x**4 - 6.0 * x**5   # p=3 polynomial
    return basis * env[:, None]


def nequip_forward(params, species, pos, src, dst, cfg: NequIPConfig,
                   edge_mask=None):
    """species: int32[nv], pos: f32[nv, 3] -> per-node scalar energy [nv].

    Padded edges must point at the ghost vertex; ghost rows contribute 0.
    """
    nv = species.shape[0]
    if edge_mask is None:
        edge_mask = src < (nv - 1)
    C = cfg.d_hidden
    paths = admissible_paths(cfg.l_max)
    cg = {p: torch.as_tensor(clebsch_gordan(*p), dtype=torch.float32,
                             device=pos.device) for p in paths}
    s, d = src.long(), dst.long()

    rvec = pos[d] - pos[s]
    r = torch.sqrt(torch.sum(rvec * rvec, dim=-1) + 1e-12)
    rhat = rvec / r[:, None]
    rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff)
    rbf = torch.where(edge_mask[:, None], rbf, 0.0)
    edge_sh = {l: sh(rhat, l) for l in range(cfg.l_max + 1)}

    h = {0: params["species_embed"][species.long()][:, :, None]}
    for l in range(1, cfg.l_max + 1):
        h[l] = torch.zeros((nv, C, 2 * l + 1), dtype=torch.float32,
                           device=pos.device)

    for lp in params["layers"]:
        rw = F.silu(rbf @ lp["radial"]["w1"]) @ lp["radial"]["w2"]
        rw = rw.reshape(-1, len(paths), C)              # [M, P, C]
        msg = {l: 0.0 for l in range(cfg.l_max + 1)}
        for pi, (l1, l2, l3) in enumerate(paths):
            t = torch.einsum(
                "eci,ej,ijk->eck", h[l1][s], edge_sh[l2], cg[(l1, l2, l3)]
            )
            msg[l3] = msg[l3] + t * rw[:, pi, :, None]
        agg = {l: common.scatter_sum(
            torch.where(edge_mask[:, None, None], msg[l], 0.0), dst, nv)
            for l in msg}
        # self-interaction + residual
        new_h = {}
        for l in range(cfg.l_max + 1):
            mixed = torch.einsum("ncm,cd->ndm", agg[l],
                                 lp["self_int"][str(l)])
            new_h[l] = h[l] + mixed
        # gate nonlinearity: scalars pass through silu and gate higher l
        scalars = new_h[0][:, :, 0]
        gates = torch.sigmoid(scalars @ lp["gates"]).reshape(
            nv, cfg.l_max, C)
        h = {0: F.silu(scalars)[:, :, None]}
        for l in range(1, cfg.l_max + 1):
            h[l] = new_h[l] * gates[:, l - 1, :, None]

    return (h[0][:, :, 0] @ params["readout"])[:, 0]
