from repro_torch.core.engine import (
    Engine,
    UnknownEngineError,
    get_engine,
    register_engine,
    registered_engines,
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

__all__ = [
    "Engine",
    "FedGAT",
    "FedGATConfig",
    "FedGATPack",
    "UnknownEngineError",
    "VectorPack",
    "fedgat_forward",
    "fedgat_layer_matrix",
    "fedgat_layer_vector",
    "get_engine",
    "init_params",
    "layered_forward",
    "make_pack",
    "pack_from_numpy",
    "params_from_numpy",
    "precompute_pack",
    "precompute_vector_pack",
    "register_engine",
    "registered_engines",
]
