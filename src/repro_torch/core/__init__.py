"""GSP-Louvain core in PyTorch: the paper's phases and the detect() API."""
from repro_torch.core.louvain import (
    LouvainConfig, louvain, louvain_impl, louvain_staged, refine_labels,
)
from repro_torch.core.local_move import local_move
from repro_torch.core.split import split_labels
from repro_torch.core.aggregate import aggregate
from repro_torch.core.detect import disconnected_communities
from repro_torch.core.modularity import modularity
from repro_torch.core.lpa import lpa, lpa_run
from repro_torch.core.portfolio import (
    ALGORITHMS, QualityContract, contract_for, tier_config,
)
from repro_torch.core.dynamic import (
    CapacityError, GraphUpdate, apply_vertex_updates, update_communities,
)
# the unified entry point (NOTE: rebinds the package attribute `detect`
# from the submodule to the function, as in the reference package)
from repro_torch.core.api import Detection, DetectOptions, detect

__all__ = [
    "ALGORITHMS",
    "CapacityError",
    "Detection",
    "DetectOptions",
    "GraphUpdate",
    "LouvainConfig",
    "QualityContract",
    "aggregate",
    "apply_vertex_updates",
    "contract_for",
    "detect",
    "disconnected_communities",
    "local_move",
    "louvain",
    "louvain_impl",
    "louvain_staged",
    "lpa",
    "lpa_run",
    "modularity",
    "refine_labels",
    "split_labels",
    "tier_config",
    "update_communities",
]
