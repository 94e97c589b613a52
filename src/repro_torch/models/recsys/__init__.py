"""RecSys models (port of ``repro/models/recsys/``): BST."""
from repro_torch.models.recsys.bst import (
    BSTConfig, bst_forward, bst_loss, bst_score_candidates, embedding_bag,
    init_bst,
)

__all__ = ["BSTConfig", "init_bst", "bst_forward", "bst_loss",
           "bst_score_candidates", "embedding_bag"]
