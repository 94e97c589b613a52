"""Graph substrate: the padded directed-COO container and its generators."""
from repro_torch.graph.container import (
    Graph, from_coo, from_undirected, remap_vertices, repad, unit_graph,
)
from repro_torch.graph.generators import (
    bridge_graph,
    grid_graph,
    random_regular_graph,
    ring_of_cliques,
    rmat_graph,
    sbm_graph,
)
from repro_torch.graph.interop import graph_from_arrays

__all__ = [
    "Graph",
    "from_coo",
    "from_undirected",
    "graph_from_arrays",
    "remap_vertices",
    "repad",
    "unit_graph",
    "sbm_graph",
    "rmat_graph",
    "ring_of_cliques",
    "bridge_graph",
    "grid_graph",
    "random_regular_graph",
]
