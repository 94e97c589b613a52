"""Graph substrate: the padded directed-COO container, its generators and
the vertex-aligned edge partition of the sharded path."""
from repro_torch.graph.container import (
    Graph, from_coo, from_networkx, from_undirected, remap_vertices, repad,
    unit_graph,
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
from repro_torch.graph.partition import (
    partition_edges_by_src, reassemble_edges, shard_graph, shard_vertex_roles,
)

__all__ = [
    "Graph",
    "from_coo",
    "from_networkx",
    "from_undirected",
    "graph_from_arrays",
    "partition_edges_by_src",
    "reassemble_edges",
    "remap_vertices",
    "repad",
    "unit_graph",
    "shard_graph",
    "shard_vertex_roles",
    "sbm_graph",
    "rmat_graph",
    "ring_of_cliques",
    "bridge_graph",
    "grid_graph",
    "random_regular_graph",
]
