"""GSP-Louvain core in PyTorch: the paper's phases and the detect() API."""
from repro_torch.core.louvain import LouvainConfig, louvain, louvain_impl
from repro_torch.core.local_move import local_move
from repro_torch.core.split import split_labels
from repro_torch.core.aggregate import aggregate
from repro_torch.core.detect import disconnected_communities
from repro_torch.core.modularity import modularity
from repro_torch.core.portfolio import (
    ALGORITHMS, QualityContract, contract_for,
)
# the unified entry point (NOTE: rebinds the package attribute `detect`
# from the submodule to the function, as in the reference package)
from repro_torch.core.api import Detection, DetectOptions, detect

__all__ = [
    "ALGORITHMS",
    "Detection",
    "DetectOptions",
    "LouvainConfig",
    "QualityContract",
    "aggregate",
    "contract_for",
    "detect",
    "disconnected_communities",
    "local_move",
    "louvain",
    "louvain_impl",
    "modularity",
    "split_labels",
]
