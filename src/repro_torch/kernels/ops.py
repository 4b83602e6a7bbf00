"""FedGAT layer 1 through the fused ``cheb_attn`` kernel (the ``kernel`` engine).

The port of ``repro/kernels/ops.py::cheb_attn_layer``. The reference pads N
and d to block multiples chosen by a TPU VMEM cost model
(``select_block_sizes``); the CUDA kernel masks ragged edges itself, so
neither the padding nor the block-size model is carried over.
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch

from repro_torch.core.poly_attention import edge_scores, head_projections
from repro_torch.kernels.cheb_attn import cheb_attn


def cheb_attn_layer(
    params: Mapping[str, torch.Tensor],
    coeffs: torch.Tensor,
    h: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    *,
    basis: str = "power",
    domain: Tuple[float, float] = (-4.0, 4.0),
    concat: bool = True,
) -> torch.Tensor:
    """FedGAT layer 1 via the fused kernel: all heads aggregate in one
    launch, then the output projection W — numerically the direct engine.
    Isolated nodes come out as exact zeros before the projection.
    Differentiable: the scores carry the parameters' gradient into
    ``cheb_attn``'s backward kernel (and ``h`` its own, when it needs one).
    ``domain`` is unused by the monomial basis and kept for the engine
    interface."""
    if basis != "power":
        raise ValueError("kernel engine evaluates the monomial (power) basis")
    n = h.shape[0]
    b1, b2 = head_projections(params)
    x = edge_scores(b1, b2, h, nbr_idx)                  # (H, N, B)
    mask_f = nbr_mask.to(h.dtype)                        # (N, B)
    h_nb = h[nbr_idx] * mask_f[..., None]                # (N, B, d)
    agg = cheb_attn(x, h_nb, mask_f, coeffs)             # (H, N, d)
    out = torch.einsum("hnd,hdo->hno", agg, params["W"])  # (H, N, d_out)
    if concat:
        return out.permute(1, 0, 2).reshape(n, -1)
    return out.mean(dim=0)
