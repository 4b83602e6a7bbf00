from repro_torch.graphs.graph import (
    Graph,
    csr_to_padded,
    edge_list,
    edges_to_csr,
    make_graph,
    make_graph_from_edges,
    sample_neighbors,
    subgraph,
)
from repro_torch.graphs.synthetic import (
    DATASET_PRESETS,
    SBM_PRESETS,
    make_cora_like,
    make_sbm,
)

__all__ = [
    "DATASET_PRESETS",
    "Graph",
    "SBM_PRESETS",
    "csr_to_padded",
    "edge_list",
    "edges_to_csr",
    "make_cora_like",
    "make_graph",
    "make_graph_from_edges",
    "make_sbm",
    "sample_neighbors",
    "subgraph",
]
