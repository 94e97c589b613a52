"""GNN zoo (port of ``repro/models/gnn/``): GCN, GAT, GatedGCN
(segment-op message passing) and NequIP (E(3)-equivariant tensor-product
message passing), over padded edge lists.

``init_*(gen, cfg, device=None)`` draws the parameters from a
``torch.Generator`` (on its device, placed on ``device``); the trees keep
the reference's keys, nesting and shapes.
"""
from repro_torch.models.gnn.gat import GATConfig, gat_forward, init_gat
from repro_torch.models.gnn.gatedgcn import (
    GatedGCNConfig, gatedgcn_forward, init_gatedgcn,
)
from repro_torch.models.gnn.gcn import GCNConfig, gcn_forward, init_gcn
from repro_torch.models.gnn.nequip import (
    NequIPConfig, init_nequip, nequip_forward,
)

__all__ = [
    "GCNConfig", "init_gcn", "gcn_forward",
    "GATConfig", "init_gat", "gat_forward",
    "GatedGCNConfig", "init_gatedgcn", "gatedgcn_forward",
    "NequIPConfig", "init_nequip", "nequip_forward",
]
