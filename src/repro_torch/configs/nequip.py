"""NequIP [arXiv:2101.03164; paper] — 5 layers, 32 hidden, l_max=2,
8 RBFs, cutoff 5.0 A, E(3) tensor-product messages."""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES
from repro_torch.models.gnn import NequIPConfig

CONFIG = NequIPConfig(name="nequip", n_layers=5, d_hidden=32, l_max=2,
                      n_rbf=8, cutoff=5.0)
SMOKE = NequIPConfig(name="nequip-smoke", n_layers=2, d_hidden=8, l_max=2,
                     n_rbf=4, cutoff=5.0)

SPEC = ArchSpec(
    arch_id="nequip",
    family="gnn",
    config=CONFIG,
    smoke=SMOKE,
    shapes=GNN_SHAPES,
    source="[arXiv:2101.03164; paper]",
    notes="positions/species are the model inputs; non-molecular shapes get "
          "synthetic 3D embeddings of the graph (input_specs provides them)",
)
