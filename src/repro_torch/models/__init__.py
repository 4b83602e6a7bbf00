"""The language-model zoo (the port of ``repro/models``): ten assigned
architectures in five families over parameter trees with the reference's
key paths. Every product runs in plain PyTorch, as the reference computes
it in jnp: no kernel is on this path."""
from repro_torch.models.zoo import Model, build_model, params_from_numpy

__all__ = ["Model", "build_model", "params_from_numpy"]
