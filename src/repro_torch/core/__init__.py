from repro_torch.core.engine import (
    Engine,
    UnknownEngineError,
    get_engine,
    register_engine,
    registered_engines,
)
from repro_torch.core.fedgat_model import (
    FedGAT,
    FedGATConfig,
    init_params,
    layered_forward,
    params_from_numpy,
)

__all__ = [
    "Engine",
    "FedGAT",
    "FedGATConfig",
    "UnknownEngineError",
    "get_engine",
    "init_params",
    "layered_forward",
    "params_from_numpy",
    "register_engine",
    "registered_engines",
]
