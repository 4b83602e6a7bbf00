"""Federated training for the port: partition, communication accounting,
aggregation and the vmap-backend Trainer (paper Algorithm 2)."""
from repro_torch.federated.aggregation import fedadam_server, fedadam_update, fedavg, fedprox_grad
from repro_torch.federated.comm import CommReport, matrix_comm_cost, vector_comm_cost
from repro_torch.federated.partition import (
    ClientSubgraph,
    Partition,
    client_halo_nodes,
    client_neighbor_masks,
    client_subgraph,
    client_train_masks,
    cross_client_edge_count,
    dirichlet_partition,
    l_hop_sizes,
)
from repro_torch.federated.trainer import (
    FederatedConfig,
    Trainer,
    run_federated,
    train_centralized,
)

__all__ = [
    "ClientSubgraph",
    "CommReport",
    "FederatedConfig",
    "Partition",
    "Trainer",
    "client_halo_nodes",
    "client_neighbor_masks",
    "client_subgraph",
    "client_train_masks",
    "cross_client_edge_count",
    "dirichlet_partition",
    "fedadam_server",
    "fedadam_update",
    "fedavg",
    "fedprox_grad",
    "l_hop_sizes",
    "matrix_comm_cost",
    "run_federated",
    "train_centralized",
    "vector_comm_cost",
]
