"""Layer-1 engine registry for the FedGAT model.

The port of ``repro/core/engine.py``. The paper's interchangeable
approximations of the first GAT layer, each an :class:`Engine` registered
under a name:

* ``matrix`` — Matrix FedGAT (paper §4, Algorithms 1 and 2;
  core/fedgat_matrix.py): a projector-matrix pack;
* ``vector`` — Vector FedGAT (paper Appendix F; core/fedgat_vector.py):
  a disjoint-support vector pack;
* ``direct`` — the polynomial-attention oracle (core/poly_attention.py);
* ``kernel`` — the same layer through the fused CUDA ``cheb_attn`` kernel
  (kernels/ops.py);
* ``exact``  — the plain GAT layer (core/gat.py).

::

    engine = get_engine("matrix")(cfg)     # cfg: FedGATConfig
    pack = engine.precompute(gen, h, nbr_idx, nbr_mask)
    x = engine.apply(params, pack, coeffs, h, nbr_idx, nbr_mask, concat=True)

``gen`` is a ``torch.Generator`` on the features' device. ``get_engine``
raises :class:`UnknownEngineError` for any name that is not registered.
"""
from __future__ import annotations

from typing import Any, Callable, ClassVar, Dict, List, Optional, Type

from repro_torch.core.fedgat_matrix import fedgat_layer_matrix, precompute_pack
from repro_torch.core.fedgat_vector import fedgat_layer_vector, precompute_vector_pack
from repro_torch.core.gat import gat_layer_nbr
from repro_torch.core.poly_attention import poly_gat_layer
from repro_torch.kernels.ops import cheb_attn_layer

_ENGINES: Dict[str, Type["Engine"]] = {}


def register_engine(name: str) -> Callable[[Type["Engine"]], Type["Engine"]]:
    """Class decorator registering an :class:`Engine` under ``name``."""

    def decorator(cls: Type["Engine"]) -> Type["Engine"]:
        if name in _ENGINES:
            raise ValueError(f"engine {name!r} already registered ({_ENGINES[name]!r})")
        cls.name = name
        _ENGINES[name] = cls
        return cls

    return decorator


def unregister_engine(name: str) -> None:
    """Remove an engine from the registry (no-op if absent). Intended for
    tests and plugin teardown."""
    _ENGINES.pop(name, None)


def registered_engines() -> List[str]:
    """Names of all registered engines, sorted."""
    return sorted(_ENGINES)


class UnknownEngineError(KeyError, ValueError):
    """Unknown engine name. Subclasses both KeyError (registry contract)
    and ValueError (the ``fedgat_forward`` contract of the reference)."""

    def __str__(self):  # KeyError.__str__ would repr() the message
        return self.args[0] if self.args else ""


def get_engine(name: str) -> Type["Engine"]:
    """Resolve an engine class by name; the error lists what is available."""
    try:
        return _ENGINES[name]
    except KeyError:
        raise UnknownEngineError(
            f"unknown engine {name!r}: registered engines are {registered_engines()}"
        ) from None


class Engine:
    """Layer-1 engine interface, built from a ``FedGATConfig`` (series
    basis, domain and degree, obfuscation constant ``r``):

    * :meth:`precompute` — the one-shot pre-training communication round
      (server side). Returns the engine's pack, or ``None`` for engines
      that need none.
    * :meth:`apply` — the client-side layer-1 update from the pack (or
      directly from features, for pack-free engines).
    """

    name: ClassVar[str] = "?"
    needs_pack: ClassVar[bool] = False     # precompute() returns a payload
    needs_coeffs: ClassVar[bool] = True    # apply() consumes series coeffs
    # Pre-training communication accounting model ("matrix" | "vector" |
    # "none"; see federated/comm.py). "direct" and "kernel" simulate the
    # matrix protocol without materialising its pack, so they are charged
    # the Matrix FedGAT rate (Theorem 1), as in the reference.
    comm_cost_model: ClassVar[str] = "matrix"

    def __init__(self, cfg):
        self.cfg = cfg

    def precompute(self, gen, h, nbr_idx, nbr_mask) -> Optional[Any]:
        return None

    def apply(self, params, pack, coeffs, h, nbr_idx, nbr_mask, *, concat=True):
        raise NotImplementedError


@register_engine("matrix")
class MatrixEngine(Engine):
    """Matrix FedGAT (paper §4, Algorithms 1 and 2): projector-matrix pack."""

    needs_pack = True

    def precompute(self, gen, h, nbr_idx, nbr_mask):
        return precompute_pack(gen, h, nbr_idx, nbr_mask, self.cfg.r)

    def apply(self, params, pack, coeffs, h, nbr_idx, nbr_mask, *, concat=True):
        return fedgat_layer_matrix(
            params, pack, h, coeffs,
            basis=self.cfg.basis, domain=self.cfg.domain, concat=concat,
        )


@register_engine("vector")
class VectorEngine(Engine):
    """Vector FedGAT (paper Appendix F): disjoint-support vector pack."""

    needs_pack = True
    comm_cost_model = "vector"

    def precompute(self, gen, h, nbr_idx, nbr_mask):
        return precompute_vector_pack(gen, h, nbr_idx, nbr_mask)

    def apply(self, params, pack, coeffs, h, nbr_idx, nbr_mask, *, concat=True):
        return fedgat_layer_vector(
            params, pack, h, coeffs,
            basis=self.cfg.basis, domain=self.cfg.domain, concat=concat,
        )


@register_engine("direct")
class DirectEngine(Engine):
    """The mathematical oracle: same series, per-edge, no pack."""

    def apply(self, params, pack, coeffs, h, nbr_idx, nbr_mask, *, concat=True):
        return poly_gat_layer(
            params, coeffs, h, nbr_idx, nbr_mask,
            basis=self.cfg.basis, domain=self.cfg.domain, concat=concat,
        )


@register_engine("kernel")
class KernelEngine(Engine):
    """The fused CUDA ``cheb_attn`` kernel (plain version on CPU tensors)."""

    def apply(self, params, pack, coeffs, h, nbr_idx, nbr_mask, *, concat=True):
        return cheb_attn_layer(
            params, coeffs, h, nbr_idx, nbr_mask,
            basis=self.cfg.basis, domain=self.cfg.domain, concat=concat,
        )


@register_engine("exact")
class ExactEngine(Engine):
    """Plain GAT layer (degenerate engine, for baselines like DistGAT)."""

    needs_coeffs = False
    comm_cost_model = "none"  # no pack is communicated

    def apply(self, params, pack, coeffs, h, nbr_idx, nbr_mask, *, concat=True):
        return gat_layer_nbr(params, h, nbr_idx, nbr_mask, concat=concat)
