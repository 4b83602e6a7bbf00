"""Graph Convolutional Network (Kipf & Welling 2017): the ``fedgcn`` method
of the federated Trainer and the centralised GCN baseline.

The port of ``repro/core/gcn.py``: ``normalized_adjacency`` and
``normalized_nbr_coeffs`` (numpy, identical), ``init_gcn_params`` (the same
distribution from a ``torch.Generator``), ``gcn_forward`` over the dense
normalised adjacency and ``gcn_forward_nbr`` over padded neighbour lists,
which gives the same output without any (N, N) array.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

Params = Dict[str, torch.Tensor]


def normalized_adjacency(adj: np.ndarray) -> np.ndarray:
    """D^{-1/2} (A + I already folded) D^{-1/2}, dense float32."""
    a = adj.astype(np.float32)
    deg = a.sum(axis=1)
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    return a * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]


def normalized_nbr_coeffs(nbr_idx: np.ndarray, nbr_mask: np.ndarray) -> np.ndarray:
    """(N, B) float32 GCN coefficients over the padded neighbour lists: row
    i, slot b holds D^{-1/2}_i * D^{-1/2}_{nbr_idx[i, b]} where valid, 0
    where padded."""
    deg = nbr_mask.sum(axis=1).astype(np.float32)          # self-loop included
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    coef = d_inv_sqrt[:, None] * d_inv_sqrt[nbr_idx]
    return (coef * nbr_mask).astype(np.float32)


def init_gcn_params(
    gen: torch.Generator, d_in: int, hidden: int, num_classes: int,
    *, device: DeviceLike = None,
) -> List[Params]:
    """Glorot-uniform weights drawn from ``gen`` (a CPU generator), placed
    on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)

    def uniform(fan_in: int, fan_out: int) -> torch.Tensor:
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((fan_in, fan_out), generator=gen, dtype=torch.float32)
        return ((2.0 * u - 1.0) * lim).to(dev)

    return [{"W": uniform(d_in, hidden)}, {"W": uniform(hidden, num_classes)}]


def gcn_forward(
    params: Sequence[Params], h: torch.Tensor, a_norm: torch.Tensor
) -> torch.Tensor:
    """GCN forward over the dense normalised adjacency, ReLU between layers."""
    x = h
    for li, p in enumerate(params):
        x = a_norm @ (x @ p["W"])
        if li < len(params) - 1:
            x = torch.relu(x)
    return x


def gcn_forward_nbr(
    params: Sequence[Params], h: torch.Tensor, nbr_idx: torch.Tensor, coef: torch.Tensor
) -> torch.Tensor:
    """GCN forward over padded neighbour lists: a gather and a weighted sum
    per layer, ReLU between layers."""
    x = h
    for li, p in enumerate(params):
        xw = x @ p["W"]
        x = torch.einsum("nb,nbd->nd", coef, xw[nbr_idx])
        if li < len(params) - 1:
            x = torch.relu(x)
    return x
