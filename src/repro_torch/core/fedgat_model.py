"""End-to-end FedGAT model (paper §4 "FedGAT for Multiple GAT Layers").

The port of ``repro/core/fedgat_model.py``. Layer 1 runs the configured
engine (``matrix``, ``vector``, ``direct``, ``kernel`` or ``exact``, see
core/engine.py) from the pre-communicated pack where the engine has one;
layers l > 1 use the exact GAT update on layer-(l-1) embeddings.

Parameters keep the reference's layouts — per layer ``W (H, d_in, d_out)``,
``a1``/``a2 (H, d_out)`` — as an ``nn.ModuleList`` of ``nn.ParameterDict``s.
:func:`params_from_numpy` and :func:`pack_from_numpy` bring the
reference's parameter list and packs across.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import chebyshev
from repro_torch.core.engine import Engine, get_engine
from repro_torch.core.fedgat_matrix import FedGATPack
from repro_torch.core.fedgat_vector import VectorPack
from repro_torch.core.gat import elu, gat_layer_nbr, init_gat_layer, init_gat_params


@dataclass(frozen=True)
class FedGATConfig:
    hidden: int = 8
    heads: int = 8
    out_heads: int = 1
    num_layers: int = 2               # >=2; layer 1 approximate, rest exact
    degree: int = 16                  # Chebyshev truncation degree p
    domain: Tuple[float, float] = (-4.0, 4.0)
    basis: str = "power"              # "power" (paper) | "chebyshev" (stable)
    engine: str = "matrix"            # layer-1 engine (registry name)
    leaky_slope: float = 0.2
    r: float = 1.7                    # projector obfuscation constant

    def coeffs(self) -> np.ndarray:
        return chebyshev.attention_series(
            self.degree, self.domain, self.leaky_slope, basis=self.basis
        )


def layer_shapes(d_in: int, num_classes: int, cfg: FedGATConfig):
    """[(heads, d_in, d_out), ...] per layer, as :func:`init_params` builds them."""
    if cfg.num_layers <= 2:
        return [(cfg.heads, d_in, cfg.hidden),
                (cfg.out_heads, cfg.hidden * cfg.heads, num_classes)]
    width = cfg.hidden * cfg.heads
    return (
        [(cfg.heads, d_in, cfg.hidden)]
        + [(cfg.heads, width, cfg.hidden)] * (cfg.num_layers - 2)
        + [(cfg.out_heads, width, num_classes)]
    )


def init_params(
    gen: torch.Generator, d_in: int, num_classes: int, cfg: FedGATConfig,
    *, device: DeviceLike = None,
) -> nn.ModuleList:
    """Random GAT parameters drawn from ``gen`` (a CPU generator), placed on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    if cfg.num_layers <= 2:
        return init_gat_params(
            gen, d_in, cfg.hidden, num_classes, cfg.heads, cfg.out_heads, device=dev
        )
    return nn.ModuleList([
        init_gat_layer(gen, din, dout, heads, device=dev)
        for heads, din, dout in layer_shapes(d_in, num_classes, cfg)
    ])


def params_from_numpy(
    params: Sequence[Mapping[str, Any]], *, device: DeviceLike = None
) -> nn.ModuleList:
    """The reference's parameter list (``[{"W", "a1", "a2"}, ...]`` of
    arrays, or the GCN's ``[{"W"}, ...]``) as the port's parameters on
    ``device``, layouts unchanged, float32. Takes numpy arrays, anything
    ``np.array`` reads, and tensors."""
    dev = resolve_device(device)

    def tensor(a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return nn.ModuleList([
        nn.ParameterDict({k: nn.Parameter(tensor(layer[k])) for k in layer})
        for layer in params
    ])


def pack_from_numpy(pack: Any, *, device: DeviceLike = None) -> Any:
    """A pack of either package (the reference's ``FedGATPack`` or
    ``VectorPack`` as numpy or JAX arrays, or the port's own) as the port's
    type on ``device``: array fields become float32 tensors, ``r`` stays a
    float. ``None`` (a pack-free engine's pack) passes through. The type is
    told by the fields."""
    if pack is None:
        return None
    dev = resolve_device(device)
    fields = tuple(getattr(pack, "_fields", ()))
    for cls in (FedGATPack, VectorPack):
        if fields == cls._fields:
            break
    else:
        raise TypeError(f"not a FedGAT pack: fields {fields!r}")

    def convert(name, a):
        if name == "r":
            return float(np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a))
        if isinstance(a, torch.Tensor):
            return a.detach().to(device=dev, dtype=torch.float32)
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return cls(*(convert(name, getattr(pack, name)) for name in fields))


def layered_forward(
    engine: Engine,
    params: Sequence[Mapping[str, torch.Tensor]],
    coeffs: Optional[torch.Tensor],
    pack: Optional[Any],
    h: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
) -> torch.Tensor:
    """Engine layer 1 + exact GAT layers l > 1 -> class logits (N, C)."""
    x = engine.apply(params[0], pack, coeffs, h, nbr_idx, nbr_mask, concat=True)
    x = elu(x)
    for li in range(1, len(params)):
        last = li == len(params) - 1
        x = gat_layer_nbr(params[li], x, nbr_idx, nbr_mask, concat=not last)
        if not last:
            x = elu(x)
    return x


def graph_tensors(graph, device: torch.device):
    """``(features f32, nbr_idx int64, nbr_mask bool)`` of ``graph`` on ``device``."""
    return (
        torch.as_tensor(graph.features, dtype=torch.float32, device=device),
        torch.as_tensor(graph.nbr_idx, dtype=torch.int64, device=device),
        torch.as_tensor(graph.nbr_mask, dtype=torch.bool, device=device),
    )


class FedGAT:
    """Model facade: config + engine + series coefficients (computed once)
    + pack lifecycle, on one device (default ``cuda``)::

        model = FedGAT(FedGATConfig(engine="vector"))
        params = model.init(torch.Generator().manual_seed(0), graph)
        model.precommunicate(pack_gen, graph)          # the ONE comm round
        logits = model.apply(params, graph)            # full-graph mask
        logits = model.apply(params, graph, client_mask)

    ``pack_gen`` is a ``torch.Generator`` on the model's device.
    """

    def __init__(self, cfg: Optional[FedGATConfig] = None, *,
                 device: DeviceLike = None, **overrides):
        if cfg is None:
            cfg = FedGATConfig(**overrides)
        elif overrides:
            raise TypeError("pass either a FedGATConfig or field overrides, not both")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.engine: Engine = get_engine(cfg.engine)(cfg)
        self.coeffs: Optional[torch.Tensor] = (
            torch.as_tensor(cfg.coeffs(), dtype=torch.float32, device=self.device)
            if self.engine.needs_coeffs else None
        )
        self.pack: Optional[Any] = None
        self._pack_graph = None        # which graph the pack belongs to
        self._graph = None             # the graph whose arrays are on the device
        self._tensors = None

    def _graph_arrays(self, graph):
        """The graph's arrays on the device: moved on the first call for a
        graph object and kept for later calls with the same object."""
        if graph is not self._graph:
            with torch.inference_mode(False):     # usable by later training calls
                self._graph, self._tensors = graph, graph_tensors(graph, self.device)
        return self._tensors

    def init(self, gen: torch.Generator, graph) -> nn.ModuleList:
        """Initialise GAT parameters for ``graph``'s feature/class dims."""
        return init_params(
            gen, graph.feature_dim, graph.num_classes, self.cfg, device=self.device
        )

    def precommunicate(self, gen: Optional[torch.Generator], graph) -> Optional[Any]:
        """The one-shot pre-training communication round; stores the pack."""
        h, nbr_idx, nbr_mask = self._graph_arrays(graph)
        with torch.inference_mode(False), torch.no_grad():   # a constant of training
            self.pack = self.engine.precompute(gen, h, nbr_idx, nbr_mask)
        self._pack_graph = graph
        return self.pack

    def install_pack(self, pack: Optional[Any], graph) -> None:
        """Adopt an externally built pack (cached, patched, or built on
        another device: it is moved to this model's) as the pack for
        ``graph``, without re-running :meth:`precommunicate`."""
        if pack is not None and not self.engine.needs_pack:
            raise ValueError(
                f"engine {self.cfg.engine!r} takes no pack; refusing to install one"
            )
        self.pack = pack_from_numpy(pack, device=self.device)
        self._pack_graph = graph

    def refresh_pack(self, gen: Optional[torch.Generator], graph) -> Optional[Any]:
        """Full pack rebuild for ``graph``: :meth:`precommunicate` again, so
        the same generator state on the same device gives the same pack bit
        for bit."""
        return self.precommunicate(gen, graph)

    def apply(self, params, graph, nbr_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward pass -> class logits (N, C). ``nbr_mask`` restricts edge
        visibility (e.g. a client's view); defaults to the full-graph mask."""
        if self.engine.needs_pack:
            if self.pack is None:
                raise RuntimeError(
                    f"engine {self.cfg.engine!r} needs a pack: call "
                    "model.precommunicate(gen, graph) before model.apply(...)"
                )
            if graph is not self._pack_graph:
                raise RuntimeError(
                    f"engine {self.cfg.engine!r}: the stored pack was "
                    "precommunicated for a different graph object; call "
                    "model.precommunicate(gen, graph) for this graph first"
                )
        h, nbr_idx, full_mask = self._graph_arrays(graph)
        if nbr_mask is None:
            nbr_mask = full_mask
        return layered_forward(
            self.engine, params, self.coeffs, self.pack, h, nbr_idx, nbr_mask
        )


def make_pack(
    gen: Optional[torch.Generator], cfg: FedGATConfig,
    h: torch.Tensor, nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
) -> Optional[Any]:
    """Pre-training communication round (engine-dependent payload)."""
    return get_engine(cfg.engine)(cfg).precompute(gen, h, nbr_idx, nbr_mask)


def fedgat_forward(
    params: Sequence[Mapping[str, torch.Tensor]],
    cfg: FedGATConfig,
    coeffs: Optional[torch.Tensor],
    pack: Optional[Any],
    h: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
) -> torch.Tensor:
    """Multi-layer FedGAT forward -> class logits (N, C)."""
    engine = get_engine(cfg.engine)(cfg)
    return layered_forward(engine, params, coeffs, pack, h, nbr_idx, nbr_mask)
