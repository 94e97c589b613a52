"""GAT (cora config) [arXiv:1710.10903; paper] — 2 layers, 8 hidden,
8 attention heads."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GATConfig

CONFIG = GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8)
SMOKE = GATConfig(name="gat-smoke", n_layers=2, d_in=12, d_hidden=4,
                  n_heads=2, n_classes=3)

SPEC = ArchSpec(
    arch_id="gat-cora",
    family="gnn",
    config=CONFIG,
    smoke=SMOKE,
    shapes=GNN_SHAPES,
    source="[arXiv:1710.10903; paper]",
)
