"""Direct polynomial-attention layer (the ``direct`` engine).

The port of ``repro/core/poly_attention.py``: ``e_ij ~= series(x_ij)`` with
``x_ij = b1.h_i + b2.h_j`` and the update Eq. (7), computed directly from
per-edge quantities with no pack, and the moments ``E^(n)``, ``F^(n)`` of
Eq. (8) (``moments_direct``). It is the mathematical oracle the ``kernel``
engine is held against.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from repro_torch.core.chebyshev import eval_chebyshev, eval_power_series

Params = Mapping[str, torch.Tensor]


def head_projections(params: Params) -> Tuple[torch.Tensor, torch.Tensor]:
    """b1 = W^T a1, b2 = W^T a2 per head (paper Eq. 4). Returns (H, d_in)."""
    b1 = torch.einsum("hdo,ho->hd", params["W"], params["a1"])
    b2 = torch.einsum("hdo,ho->hd", params["W"], params["a2"])
    return b1, b2


def edge_scores(
    b1: torch.Tensor, b2: torch.Tensor, h: torch.Tensor, nbr_idx: torch.Tensor
) -> torch.Tensor:
    """x_ij = b1.h_i + b2.h_j over padded neighbour lists. -> (H, N, B)."""
    s1 = torch.einsum("nd,hd->hn", h, b1)
    s2 = torch.einsum("nd,hd->hn", h, b2)
    return s1[:, :, None] + s2[:, nbr_idx]


def eval_series(
    coeffs: torch.Tensor, x: torch.Tensor, basis: str, domain: Tuple[float, float]
) -> torch.Tensor:
    if basis == "power":
        return eval_power_series(coeffs, x)
    if basis == "chebyshev":
        return eval_chebyshev(coeffs, x, domain)
    raise ValueError(f"unknown basis {basis!r}")


def moments_direct(
    x: torch.Tensor, h_nb: torch.Tensor, mask: torch.Tensor, max_n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """E^(n) = sum_j x_ij^n h_j, F^(n) = sum_j x_ij^n (paper Eq. 8).

    x: (..., B), h_nb: (..., B, d), mask: (..., B) ->
    E: (max_n+1, ..., d), F: (max_n+1, ...). The reference scans over n;
    this loop carries the same power ``xp`` and stacks the moments.
    """
    m = mask.to(x.dtype)
    xp = torch.ones_like(x)
    E, F = [], []
    for _ in range(max_n + 1):
        E.append(torch.einsum("...b,...bd->...d", xp * m, h_nb))
        F.append(torch.sum(xp * m, dim=-1))
        xp = xp * x
    return torch.stack(E), torch.stack(F)


def poly_gat_layer(
    params: Params,
    coeffs: torch.Tensor,
    h: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    *,
    basis: str = "power",
    domain: Tuple[float, float] = (-4.0, 4.0),
    concat: bool = True,
) -> torch.Tensor:
    """Approximate GAT layer via the truncated series (paper Eq. 7).
    h: (N, d_in) -> (N, H*d_out) or (N, d_out)."""
    b1, b2 = head_projections(params)
    x = edge_scores(b1, b2, h, nbr_idx)                       # (H, N, B)
    e = eval_series(coeffs, x, basis, domain)
    e = e * nbr_mask[None].to(e.dtype)
    den = torch.sum(e, dim=-1, keepdim=True)                  # (H, N, 1)
    num = torch.einsum("hnb,nbd->hnd", e, h[nbr_idx])         # (H, N, d_in)
    # Isolated/fully-masked rows sum to exactly zero: they aggregate to zero
    # instead of 0/0 NaN, the same guard as the kernel engine.
    ok = den != 0
    agg = torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)
    out = torch.einsum("hnd,hdo->hno", agg, params["W"])      # (H, N, d_out)
    if concat:
        return out.permute(1, 0, 2).reshape(h.shape[0], -1)
    return out.mean(dim=0)
