"""Graph Attention Network layers — paper Eq. (1)-(3).

The port of ``repro/core/gat.py``: the exact GAT layer in its two
equivalent forms, ``gat_layer_dense`` over a dense (N, N) adjacency (the
oracle for small graphs) and ``gat_layer_nbr`` over padded neighbour lists
(layers l > 1 of every engine, and the whole of the ``exact`` engine), the
two-layer ``gat_forward`` over either, its activations, parameter init,
the masked cross-entropy loss and the masked accuracy metric.

Parameters keep the reference's layout: one mapping per layer with
``W (H, d_in, d_out)``, ``a1 (H, d_out)`` and ``a2 (H, d_out)``; a model's
parameters are an ``nn.ModuleList`` of ``nn.ParameterDict``s.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import torch
from torch import nn

from repro_torch.kernels.nbr_gather import nbr_gather

LEAKY_SLOPE = 0.2


def leaky_relu(x: torch.Tensor, slope: float = LEAKY_SLOPE) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(x))


def init_gat_layer(
    gen: torch.Generator, d_in: int, d_out: int, heads: int, scale: float = 0.5,
    *, device: torch.device | str = "cpu", skip: bool = False,
) -> nn.ParameterDict:
    """Glorot-ish uniform init, scaled down so Assumption 2 (norm <= 1)
    loosely holds. Same distribution as the reference, different bits:
    the draws come from ``gen`` (a CPU generator) and then move to
    ``device``. With ``skip``, a skip projection ``P`` shaped and drawn like
    ``W`` follows ``a2``."""
    lim = scale * math.sqrt(6.0 / (d_in + d_out))

    def uniform(*shape: int) -> nn.Parameter:
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        return nn.Parameter(((2.0 * u - 1.0) * lim).to(device))

    layer = nn.ParameterDict({
        "W": uniform(heads, d_in, d_out),
        "a1": uniform(heads, d_out),
        "a2": uniform(heads, d_out),
    })
    if skip:
        layer["P"] = uniform(heads, d_in, d_out)
    return layer


def init_gat_params(
    gen: torch.Generator, d_in: int, hidden: int, num_classes: int,
    heads: int = 8, out_heads: int = 1, *, device: torch.device | str = "cpu",
) -> nn.ModuleList:
    return nn.ModuleList([
        init_gat_layer(gen, d_in, hidden, heads, device=device),
        init_gat_layer(gen, hidden * heads, num_classes, out_heads, device=device),
    ])


def gat_layer_dense(
    params: Mapping[str, torch.Tensor], h: torch.Tensor, adj: torch.Tensor, concat: bool
) -> torch.Tensor:
    """h: (N, d_in), adj: (N, N) bool. Returns (N, heads*d_out) or (N, d_out)."""
    z = torch.einsum("nd,hdo->hno", h, params["W"])          # (H, N, d_out)
    s1 = torch.einsum("hno,ho->hn", z, params["a1"])         # score of dst i
    s2 = torch.einsum("hno,ho->hn", z, params["a2"])         # score of src j
    logits = leaky_relu(s1[:, :, None] + s2[:, None, :])     # (H, N, N), ij
    logits = torch.where(adj[None], logits, -torch.inf)
    alpha = torch.softmax(logits, dim=-1)
    alpha = torch.where(adj[None], alpha, 0.0)
    out = torch.einsum("hnm,hmo->hno", alpha, z)             # (H, N, d_out)
    if concat:
        return out.permute(1, 0, 2).reshape(h.shape[0], -1)
    return out.mean(dim=0)


def gat_layer_nbr(
    params: Mapping[str, torch.Tensor],
    h: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    concat: bool,
) -> torch.Tensor:
    """h: (N, d_in), nbr_idx (int64) / nbr_mask (bool): (N, B).
    Returns (N, heads*d_out) or (N, d_out)."""
    z = torch.einsum("nd,hdo->hno", h, params["W"])          # (H, N, d_out)
    s1 = torch.einsum("hno,ho->hn", z, params["a1"])         # (H, N)
    s2 = torch.einsum("hno,ho->hn", z, params["a2"])         # (H, N)
    logits = leaky_relu(s1[:, :, None] + nbr_gather(s2[..., None], nbr_idx)[..., 0])  # (H, N, B)
    logits = torch.where(nbr_mask[None], logits, -torch.inf)
    alpha = torch.softmax(logits, dim=-1)
    alpha = torch.where(nbr_mask[None], alpha, 0.0)          # isolated rows: 0
    out = torch.einsum("hnb,hnbo->hno", alpha, nbr_gather(z, nbr_idx))
    if concat:
        return out.permute(1, 0, 2).reshape(h.shape[0], -1)
    return out.mean(dim=0)


def skip_projection(P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x P_k`` for each head k, concatenated as a concat layer's heads:
    x (N, d_in), P (H, d_in, d_out) -> (N, H * d_out), one GEMM."""
    heads, d_in, d_out = P.shape
    return x @ P.permute(1, 0, 2).reshape(d_in, heads * d_out)


def gat_forward(
    params: Sequence[Mapping[str, torch.Tensor]], h: torch.Tensor,
    adj: Optional[torch.Tensor], *, use_nbr: bool = False,
    nbr_idx: Optional[torch.Tensor] = None, nbr_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Two-layer GAT: ELU between layers, raw logits out. Over the dense
    ``adj`` by default, over ``nbr_idx``/``nbr_mask`` with ``use_nbr``."""
    x = h
    for li, p in enumerate(params):
        last = li == len(params) - 1
        if use_nbr:
            x = gat_layer_nbr(p, x, nbr_idx, nbr_mask, not last)
        else:
            x = gat_layer_dense(p, x, adj, not last)
        if not last:
            x = elu(x)
    return x


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Mean negative log-likelihood over the nodes where ``mask`` is set."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[:, None].long())[:, 0]
    mask = mask.to(logits.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def masked_accuracy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)
    correct = (pred == labels).to(torch.float32)
    mask = mask.to(torch.float32)
    return torch.sum(correct * mask) / torch.clamp(torch.sum(mask), min=1.0)
