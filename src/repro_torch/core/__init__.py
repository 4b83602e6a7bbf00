from repro_torch.core import chebyshev
from repro_torch.core.engine import (
    Engine,
    UnknownEngineError,
    get_engine,
    register_engine,
    registered_engines,
    unregister_engine,
)
from repro_torch.core.fedgat_matrix import FedGATPack, fedgat_layer_matrix, precompute_pack
from repro_torch.core.fedgat_model import (
    FedGAT,
    FedGATConfig,
    fedgat_forward,
    init_params,
    layered_forward,
    make_pack,
    pack_from_numpy,
    params_from_numpy,
)
from repro_torch.core.fedgat_vector import VectorPack, fedgat_layer_vector, precompute_vector_pack
from repro_torch.core.gat import (
    gat_forward,
    gat_layer_dense,
    gat_layer_nbr,
    init_gat_params,
    masked_accuracy,
    masked_cross_entropy,
)
from repro_torch.core.gcn import gcn_forward, init_gcn_params, normalized_adjacency
from repro_torch.core.poly_attention import (
    edge_scores,
    head_projections,
    moments_direct,
    poly_gat_layer,
)

__all__ = [
    "Engine",
    "FedGAT",
    "FedGATConfig",
    "FedGATPack",
    "UnknownEngineError",
    "VectorPack",
    "chebyshev",
    "edge_scores",
    "fedgat_forward",
    "fedgat_layer_matrix",
    "fedgat_layer_vector",
    "gat_forward",
    "gat_layer_dense",
    "gat_layer_nbr",
    "gcn_forward",
    "get_engine",
    "head_projections",
    "init_gat_params",
    "init_gcn_params",
    "init_params",
    "layered_forward",
    "make_pack",
    "masked_accuracy",
    "masked_cross_entropy",
    "moments_direct",
    "normalized_adjacency",
    "pack_from_numpy",
    "params_from_numpy",
    "poly_gat_layer",
    "precompute_pack",
    "precompute_vector_pack",
    "register_engine",
    "registered_engines",
    "unregister_engine",
]
