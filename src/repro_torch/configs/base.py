"""Config registry (port of ``repro/configs/base.py``): one module per
assigned architecture.

Each ``repro_torch/configs/<arch>.py`` exports ``SPEC: ArchSpec`` holding the
exact published configuration, a reduced smoke configuration, and the
architecture's shape set.  ``get_spec('mixtral-8x7b')`` resolves ids.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

ARCH_IDS = [
    "mixtral-8x7b",
    "mixtral-8x22b",
    "command-r-35b",
    "smollm-360m",
    "tinyllama-1.1b",
    "gat-cora",
    "nequip",
    "gatedgcn",
    "gcn-cora",
    "bst",
    # the paper's own workload, exposed as a selectable arch
    "louvain",
]


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                  # lm | gnn | recsys | graph
    config: Any                  # full published config
    smoke: Any                   # reduced config for CPU smoke tests
    shapes: dict                 # shape name -> dict of shape params
    skip_shapes: dict = dataclasses.field(default_factory=dict)
    source: str = ""             # [citation; verification tier]
    notes: str = ""


# ---- canonical shape sets (assignment block) ------------------------------

LM_SHAPES = dict(
    train_4k=dict(kind="train", seq_len=4096, global_batch=256),
    prefill_32k=dict(kind="prefill", seq_len=32768, global_batch=32),
    decode_32k=dict(kind="decode", seq_len=32768, global_batch=128),
    long_500k=dict(kind="decode", seq_len=524288, global_batch=1),
)

GNN_SHAPES = dict(
    full_graph_sm=dict(kind="full", n_nodes=2708, n_edges=10556, d_feat=1433,
                       n_classes=7),
    minibatch_lg=dict(kind="sampled", n_nodes=232965, n_edges=114_615_892,
                      batch_nodes=1024, fanout=(15, 10), d_feat=602,
                      n_classes=41),
    ogb_products=dict(kind="full", n_nodes=2_449_029, n_edges=61_859_140,
                      d_feat=100, n_classes=47),
    molecule=dict(kind="batched", n_nodes=30, n_edges=64, batch=128,
                  d_feat=16, n_classes=1),
)

RECSYS_SHAPES = dict(
    train_batch=dict(kind="train", batch=65536),
    serve_p99=dict(kind="serve", batch=512),
    serve_bulk=dict(kind="serve", batch=262144),
    retrieval_cand=dict(kind="retrieval", batch=1, n_candidates=1_000_000),
)

# paper Table 1-scale synthetic graphs for the paper's own workload
GRAPH_SHAPES = dict(
    web_uk2002=dict(kind="community", n_nodes=18_520_486, n_edges=567_000_000),
    road_europe=dict(kind="community", n_nodes=50_912_018, n_edges=108_109_320),
    soc_orkut=dict(kind="community", n_nodes=3_072_441, n_edges=234_370_166),
    kmer_v1r=dict(kind="community", n_nodes=214_005_017, n_edges=465_410_904),
)


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch '{arch_id}'; known: {ARCH_IDS}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_").replace(".", "_")
    )
    return mod.SPEC


def all_cells(include_graph: bool = False):
    """Every (arch, shape) pair in the assignment matrix (+skips marked)."""
    cells = []
    for a in ARCH_IDS:
        if a == "louvain" and not include_graph:
            continue
        spec = get_spec(a)
        for s in spec.shapes:
            cells.append((a, s, spec.skip_shapes.get(s)))
    return cells
