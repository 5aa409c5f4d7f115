"""The graph library (GraphX parity): ``Graph``, ``pregel`` and the
algorithms on it, on one device."""

from asyncframework_tpu_torch.graph.graph import Graph
from asyncframework_tpu_torch.graph.pregel import pregel
from asyncframework_tpu_torch.graph.algorithms import (
    SVDPlusPlusModel,
    connected_components,
    label_propagation,
    pagerank,
    partition_edges,
    personalized_pagerank,
    shortest_paths,
    strongly_connected_components,
    svd_plus_plus,
    triangle_count,
)

__all__ = [
    "Graph", "pregel", "pagerank", "connected_components",
    "triangle_count", "label_propagation", "shortest_paths",
    "partition_edges", "strongly_connected_components",
    "svd_plus_plus", "SVDPlusPlusModel", "personalized_pagerank",
]
