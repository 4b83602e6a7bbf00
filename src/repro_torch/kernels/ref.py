"""Plain PyTorch versions of the port's kernels.

``cheb_attn_ref`` is the port of ``repro/kernels/ref.py::cheb_attn_ref``;
``cheb_attn_bwd_ref`` is its backward written out as formulas. The CPU
tests run both through the kernel wrapper (CPU tensors take the plain
versions), and ``chip_smoke.py`` holds the CUDA kernels against them on
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


def _batched4(x, h_nb, mask):
    """The three layouts as (G, H, N, B), (G, N, B, D), (G, N, B) views."""
    if x.dim() == 2:
        return x[None, None], h_nb[None], mask[None]
    if x.dim() == 3:
        return x[None], h_nb[None], mask[None]
    return x, h_nb, mask


def cheb_attn_bwd_ref(
    x: torch.Tensor, h_nb: torch.Tensor, mask: torch.Tensor, coeffs: torch.Tensor,
    dout: torch.Tensor, needs=(True, True, True, True),
):
    """Cotangents ``(dx, dh_nb, dmask, dcoeffs)`` of :func:`cheb_attn_ref`
    given ``dout``, written out as formulas (layouts as the forward; the
    port of the backward of ``repro/kernels/cheb_attn.py::cheb_attn_diff``,
    which is ``jax.vjp`` of the oracle). With ``e = poly(x) * m``,
    ``den = sum_b e`` and ``out`` the forward's result::

      g_e    = sum_d dout * (h_nb - out) / den     (0 where den == 0)
      dx     = g_e * m * poly'(x)
      dh_nb  = sum_h (e / den) * dout              (0 where den == 0)
      dmask  = sum_h g_e * poly(x)
      dcoeffs[k] = sum g_e * m * x^k

    ``needs`` marks which cotangents to compute; the others are ``None``.
    """
    x4, h4, m4 = _batched4(x, h_nb, mask)
    dout4 = dout.reshape(x4.shape[:-1] + dout.shape[-1:])
    coeffs = torch.as_tensor(coeffs, dtype=x.dtype, device=x.device)
    p = torch.zeros_like(x4)
    dp = torch.zeros_like(x4)
    for qn in coeffs.flip(0):
        dp = dp * x4 + p
        p = p * x4 + qn
    m = m4.to(x.dtype)[:, None]                                # (G, 1, N, B)
    e = p * m
    den = e.sum(-1, keepdim=True)
    ok = den != 0
    safe = torch.where(ok, den, 1.0)
    out = torch.where(ok, torch.einsum("ghnb,gnbd->ghnd", e, h4) / safe, 0.0)
    s = torch.einsum("ghnd,gnbd->ghnb", dout4, h4) - (dout4 * out).sum(-1, keepdim=True)
    g_e = torch.where(ok, s / safe, 0.0)
    dx = dh = dmask = dcoeffs = None
    if needs[0]:
        dx = (g_e * m * dp).reshape(x.shape)
    if needs[1]:
        w = torch.where(ok, e / safe, 0.0)
        dh = torch.einsum("ghnb,ghnd->gnbd", w, dout4).reshape(h_nb.shape)
    if needs[2]:
        dmask = (g_e * p).sum(1).reshape(mask.shape)
    if needs[3]:
        gp = g_e * m
        terms = []
        for _ in range(coeffs.numel()):
            terms.append(gp.sum())
            gp = gp * x4
        dcoeffs = torch.stack(terms)
    return dx, dh, dmask, dcoeffs
