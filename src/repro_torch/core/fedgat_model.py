"""End-to-end FedGAT model (paper §4 "FedGAT for Multiple GAT Layers").

The port of ``repro/core/fedgat_model.py`` for the pack-free engines.
Layer 1 runs the configured engine (``direct``, ``kernel`` or ``exact``);
layers l > 1 use the exact GAT update on layer-(l-1) embeddings.

Parameters keep the reference's layouts — per layer ``W (H, d_in, d_out)``,
``a1``/``a2 (H, d_out)`` — as an ``nn.ModuleList`` of ``nn.ParameterDict``s.
:func:`params_from_numpy` brings the reference's parameter list across.
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
    """Model facade for the pack-free engines: config + engine + series
    coefficients (computed once), on one device (default ``cuda``)::

        model = FedGAT(FedGATConfig(engine="kernel"))
        params = model.init(torch.Generator().manual_seed(0), graph)
        logits = model.apply(params, graph)            # full-graph mask
        logits = model.apply(params, graph, client_mask)
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
        self._graph = None             # the graph whose arrays are on the device
        self._tensors = None

    def init(self, gen: torch.Generator, graph) -> nn.ModuleList:
        """Initialise GAT parameters for ``graph``'s feature/class dims."""
        return init_params(
            gen, graph.feature_dim, graph.num_classes, self.cfg, device=self.device
        )

    def apply(self, params, graph, nbr_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Forward pass -> class logits (N, C). ``nbr_mask`` restricts edge
        visibility (e.g. a client's view); defaults to the full-graph mask.
        The graph's arrays go to the device on the first call for a graph
        object and are kept for later calls with the same object."""
        if graph is not self._graph:
            with torch.inference_mode(False):     # usable by later training calls
                self._graph, self._tensors = graph, graph_tensors(graph, self.device)
        h, nbr_idx, full_mask = self._tensors
        if nbr_mask is None:
            nbr_mask = full_mask
        return layered_forward(
            self.engine, params, self.coeffs, None, h, nbr_idx, nbr_mask
        )
