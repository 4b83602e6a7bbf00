"""Pre-training communication cost accounting (paper Theorem 1, Appendix D/F).

Costs are reported in *scalar counts*, matching the paper's Figures 3-4/7-8.

Matrix FedGAT, per node i shipped to a client:
    {M1_i(s), M2_i(s)}_{s=1..d} : 2 * d * (2 deg_i)^2
    K1_i                        : 2 deg_i
    K2_i                        : 2 deg_i * d
Vector FedGAT, per node i:
    M1_i, M2_i : 2 * d * 2 deg_i
    K1_i       : 2 deg_i * d
    K2_i, K3_i : 2 * 2 deg_i

A node's pack is shipped to every client whose (L-1)-hop neighbourhood of
its local set contains the node (the client computes layer-1 embeddings for
its local nodes and their (L-1)-hop halo). Upload cost is O(N d) (features
to the server) and is reported separately.

The port of ``repro/federated/comm.py``; the meters read the port's
engine registry.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.federated.partition import Partition, _reach, cross_client_edge_count
from repro_torch.graphs.graph import Graph


class CommReport(NamedTuple):
    upload_scalars: int        # client -> server feature upload
    download_scalars: int      # server -> client pack download
    per_client: np.ndarray     # (K,) download per client
    cross_client_edges: int


def _halo_indicator(g: Graph, part: Partition, hops: int) -> np.ndarray:
    """(K, N) bool: node needed by client k (local set + `hops`-hop halo).

    Expands each client's frontier over the CSR edge list (O(K * hops * E));
    the old `(g.adj @ frontier) > 0` matmul form was O(K * hops * N^2)."""
    K = part.num_clients
    need = np.zeros((K, g.num_nodes), dtype=bool)
    for k in range(K):
        need[k] = _reach(g, part.owner == k, hops)
    return need


def _pack_cost_per_node(g: Graph, kind: str) -> np.ndarray:
    deg = g.nbr_mask.sum(axis=1).astype(np.int64)          # includes self-loop
    d = g.feature_dim
    two_deg = 2 * deg
    if kind == "matrix":
        return 2 * d * two_deg**2 + two_deg + two_deg * d
    if kind == "vector":
        return 2 * d * two_deg + two_deg * d + 2 * two_deg
    raise ValueError(kind)


def _comm_cost(g: Graph, part: Partition, kind: str, num_layers: int) -> CommReport:
    per_node = _pack_cost_per_node(g, kind)
    need = _halo_indicator(g, part, hops=max(num_layers - 1, 0))
    per_client = (need * per_node[None, :]).sum(axis=1)
    return CommReport(
        upload_scalars=int(g.num_nodes * g.feature_dim),
        download_scalars=int(per_client.sum()),
        per_client=per_client,
        cross_client_edges=cross_client_edge_count(g, part),
    )


def matrix_comm_cost(g: Graph, part: Partition, num_layers: int = 2) -> CommReport:
    return _comm_cost(g, part, "matrix", num_layers)


def vector_comm_cost(g: Graph, part: Partition, num_layers: int = 2) -> CommReport:
    return _comm_cost(g, part, "vector", num_layers)


# Cost-model name (Engine.comm_cost_model) -> meter. None = no pack is
# communicated. "direct"/"kernel" declare "matrix": they simulate exactly
# the matrix protocol without materialising the pack.
COMM_COST_MODELS = {
    "matrix": matrix_comm_cost,
    "vector": vector_comm_cost,
    "none": None,
}


def comm_cost_for_engine(engine: str):
    """Cost meter for a registered engine, per its declared comm_cost_model."""
    from repro_torch.core.engine import get_engine

    model = get_engine(engine).comm_cost_model
    try:
        return COMM_COST_MODELS[model]
    except KeyError:
        raise ValueError(
            f"engine {engine!r} declares unknown comm_cost_model {model!r}: "
            f"known models are {sorted(COMM_COST_MODELS)}"
        ) from None
