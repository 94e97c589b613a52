"""GSP-Louvain — the paper's own workload as a selectable arch.

Shapes mirror paper Table 1 graph scales (SuiteSparse); the dry-run lowers
one full distributed pass (local-move + split + aggregate) over vertex-
aligned edge shards (DESIGN.md §4)."""
from repro_torch.configs.base import ArchSpec, GRAPH_SHAPES
from repro_torch.core.louvain import LouvainConfig

CONFIG = LouvainConfig(split="sp-pj")
SMOKE = LouvainConfig(split="sp-pj", max_passes=3, max_iters=8)

SPEC = ArchSpec(
    arch_id="louvain",
    family="graph",
    config=CONFIG,
    smoke=SMOKE,
    shapes=GRAPH_SHAPES,
    source="[this paper; Table 1 scales]",
)
