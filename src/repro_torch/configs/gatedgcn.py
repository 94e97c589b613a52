"""GatedGCN [arXiv:2003.00982; paper] — 16 layers, 70 hidden, gated
aggregation (benchmarking-gnns configuration)."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import GatedGCNConfig

CONFIG = GatedGCNConfig(name="gatedgcn", n_layers=16, d_hidden=70)
SMOKE = GatedGCNConfig(name="gatedgcn-smoke", n_layers=3, d_in=12,
                       d_hidden=16, n_classes=3)

SPEC = ArchSpec(
    arch_id="gatedgcn",
    family="gnn",
    config=CONFIG,
    smoke=SMOKE,
    shapes=GNN_SHAPES,
    source="[arXiv:2003.00982; paper]",
)
