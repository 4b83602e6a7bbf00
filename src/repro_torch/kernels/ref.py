"""Plain PyTorch versions of the port's kernels.

``cheb_attn_ref`` is the port of ``repro/kernels/ref.py::cheb_attn_ref``.
The CPU tests run it through the kernel wrapper (CPU tensors take the
plain version), and ``chip_smoke.py`` holds the CUDA kernel against it on
the card.
"""
from __future__ import annotations

import torch


def cheb_attn_ref(
    x: torch.Tensor, h_nb: torch.Tensor, mask: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """Fused polynomial-attention graph aggregation (FedGAT Eq. 7).

    Layouts (``G`` = same-shape graph batch, ``H`` = heads):

      x: (N, B),       h_nb: (N, B, D),    mask: (N, B)    -> (N, D)
      x: (H, N, B),    h_nb: (N, B, D),    mask: (N, B)    -> (H, N, D)
      x: (G, H, N, B), h_nb: (G, N, B, D), mask: (G, N, B) -> (G, H, N, D)

    ``e = sum_n q_n x^n`` by Horner from the highest coefficient, times the
    mask; ``out = sum_j e_ij h_j / sum_j e_ij``. Rows whose denominator is
    exactly zero (isolated or fully masked) return exact zeros; every other
    denominator divides, whatever its sign.
    """
    if x.dim() not in (2, 3, 4):
        raise ValueError(f"x must be (N,B), (H,N,B) or (G,H,N,B); got {tuple(x.shape)}")
    coeffs = torch.as_tensor(coeffs, dtype=x.dtype, device=x.device)
    e = torch.zeros_like(x)
    for qn in coeffs.flip(0):
        e = e * x + qn                                      # Horner
    m = mask.to(x.dtype)
    if x.dim() == 4:                                        # per-graph h/mask
        e = e * m[:, None]
        num = torch.einsum("ghnb,gnbd->ghnd", e, h_nb)
    else:
        e = e * m
        num = torch.einsum("...nb,nbd->...nd", e, h_nb)
    den = torch.sum(e, dim=-1, keepdim=True)
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)
