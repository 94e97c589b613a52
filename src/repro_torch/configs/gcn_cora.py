"""GCN (cora config) [arXiv:1609.02907; paper] — 2 layers, 16 hidden,
mean/sym aggregation.  d_in / n_classes adapt to each assigned shape."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GCNConfig

CONFIG = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16, norm="sym")
SMOKE = GCNConfig(name="gcn-smoke", n_layers=2, d_in=12, d_hidden=8,
                  n_classes=3, norm="sym")

SPEC = ArchSpec(
    arch_id="gcn-cora",
    family="gnn",
    config=CONFIG,
    smoke=SMOKE,
    shapes=GNN_SHAPES,
    source="[arXiv:1609.02907; paper]",
)
