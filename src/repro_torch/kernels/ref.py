"""Plain PyTorch versions of the port's kernels, and the reference's oracles.

``cheb_attn_ref`` is the port of ``repro/kernels/ref.py::cheb_attn_ref``;
``cheb_attn_bwd_ref`` is its backward written out as formulas. The CPU
tests run both through the kernel wrapper (CPU tensors take the plain
versions), and ``chip_smoke.py`` holds the CUDA kernels against them on
the card.

``flash_attn_ref``, ``wkv_ref`` and ``poly_attn_ref`` copy the reference's
oracles (``repro/kernels/ref.py:31,46,69``) with the same arguments and the
same arithmetic. They are used only to check: the sequence kernels' wrappers
run their own plain versions, which follow the TPU kernels (see
:mod:`~repro_torch.kernels.flash_attn`, :mod:`~repro_torch.kernels.poly_attn`
and :mod:`~repro_torch.kernels.wkv_chunk`). ``poly_attn_ref`` keeps the
oracle's ``maximum(den, 1e-9)`` guard, which differs from the TPU kernel's
on rows with a negative denominator.
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


def flash_attn_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain softmax attention. q/k/v: (B, H, S, hd) -> (B, H, S, hd)."""
    hd = q.shape[-1]
    scale = scale or hd**-0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[2]
        msk = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(msk[None, None], scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def wkv_ref(r, k, v, w, u, S0):
    """RWKV6 wkv recurrence oracle (sequential scan, one step per token).

    r/k/v/w: (BH, S, hd); u: (hd,); S0: (BH, hd, hd).
      y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
      S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns (y: (BH, S, hd) f32, S_final f32).
    """
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    uf = u.float()
    S = S0.float()
    ys = []
    for t in range(rf.shape[1]):
        kv = torch.einsum("bk,bv->bkv", kf[:, t], vf[:, t])
        ys.append(torch.einsum("bk,bkv->bv", rf[:, t], S + uf[None, :, None] * kv))
        S = wf[:, t, :, None] * S + kv
    y = torch.stack(ys, dim=1) if ys else rf.new_zeros(rf.shape)
    return y, S


def poly_attn_ref(
    q: torch.Tensor, k: torch.Tensor, a1: torch.Tensor, a2: torch.Tensor,
    v: torch.Tensor, coeffs, *, causal: bool = True, domain: float = 4.0,
) -> torch.Tensor:
    """FedGAT-style additive polynomial attention for transformers (the
    reference's oracle, argument order and guard included).

    q/k/v: (B, H, S, hd); a1/a2: (H, hd). Scores x_ij = a1.q_i + a2.k_j,
    weights = series(x) / max(sum series(x), 1e-9) over the allowed positions.
    """
    sq = torch.einsum("bhqd,hd->bhq", q.float(), a1.float())
    sk = torch.einsum("bhkd,hd->bhk", k.float(), a2.float())
    x = torch.clamp(sq[..., :, None] + sk[..., None, :], -domain, domain)
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=q.device)
    e = torch.zeros_like(x)
    for qn in coeffs.flip(0):
        e = e * x + qn
    if causal:
        S = q.shape[2]
        msk = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        e = e * msk[None, None]
    num = torch.einsum("bhqk,bhkd->bhqd", e, v.float())
    den = torch.sum(e, dim=-1, keepdim=True)
    return (num / torch.clamp(den, min=1e-9)).to(q.dtype)
