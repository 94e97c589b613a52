"""Deterministic synthetic data (port of ``repro/data/``): the token,
recsys and GNN-label streams, the graph fixtures and the graph-event
streams of temporal tracking."""
from repro_torch.data.streams import (
    DEFAULT_CHURN_MIX, GraphEvent, gnn_node_labels, graph_dataset,
    graph_event_stream, planted_timeline_script, recsys_stream,
    token_stream,
)

__all__ = ["DEFAULT_CHURN_MIX", "GraphEvent", "gnn_node_labels",
           "graph_dataset", "graph_event_stream", "planted_timeline_script",
           "recsys_stream", "token_stream"]
