"""Deterministic synthetic data (port of ``repro/data/``): the graph
fixtures and the graph-event streams of temporal tracking."""
from repro_torch.data.streams import (
    DEFAULT_CHURN_MIX, GraphEvent, graph_dataset, graph_event_stream,
    planted_timeline_script,
)

__all__ = ["DEFAULT_CHURN_MIX", "GraphEvent", "graph_dataset",
           "graph_event_stream", "planted_timeline_script"]
