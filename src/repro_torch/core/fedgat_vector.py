"""Vector FedGAT — the paper's Appendix F efficient variant.

The port of ``repro/core/fedgat_vector.py``. The 2B x 2B projector
matrices become disjoint-support binary vectors and masks, cutting
pre-training communication from O(d B^3) per client to O(d B^2)
(Theorem 1 vs Appendix F) at the cost of the weaker, conditional privacy
argument the paper notes.

Layout (per node i, padded degree B, g = 2B):
  u_j = e_{2j}                      (valid neighbour slots live on EVEN idx)
  masks live on ODD indices         (obfuscation; orthogonal to all u_j)

Communicated quantities (Appendix F):
  M1_i = mask1_i + h_i (sum_j u_j)^T        (d, g)
  M2_i = mask2_i + sum_j h_j u_j^T          (d, g)
  K1_i = mask3_i + sum_j u_j h_j^T          (g, d)
  K2_i = mask4_i = valid-even-slot indicator (g,)
  K3_i = mask5_i + sum_j u_j                 (g,)

Client-side (per head):
  D = b1^T M1 + b2^T M2                      (g,)
  R = D * mask4          -> R = sum_j x_ij u_j^T   (elementwise masking)
  s = Horner(q, R) * mask4   (the n=0 term must be q_0 on VALID slots only)
  E-series = s @ K1,  F-series = s . K3      (mask supports cancel)

The masks' odd slots are zeroed exactly by ``mask4``, so the layer's output
does not depend on the draw. The client side runs node-major, (N, H, g),
with every contraction a batched matmul over nodes.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.fedgat_matrix import aggregate
from repro_torch.core.poly_attention import eval_series, head_projections

Params = Mapping[str, torch.Tensor]


class VectorPack(NamedTuple):
    M1: torch.Tensor     # (N, d, g)
    M2: torch.Tensor     # (N, d, g)
    K1: torch.Tensor     # (N, g, d)
    K3: torch.Tensor     # (N, g)
    mask4: torch.Tensor  # (N, g)  — this IS K2 in the appendix's notation


def precompute_vector_pack(
    gen: Optional[torch.Generator],
    h: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    *,
    masks: Optional[Sequence[torch.Tensor]] = None,
) -> VectorPack:
    """The Appendix F pack. ``masks`` are the four raw normals behind
    mask1, mask2, mask3 and mask5 ((N, d, g), (N, d, g), (N, g, d), (N, g));
    the odd-slot indicator is applied here. By default they are drawn from
    ``gen`` on the features' device, in that order."""
    n, b = nbr_mask.shape
    d = h.shape[1]
    g = 2 * b
    dev, dt = h.device, h.dtype
    valid = nbr_mask.to(dt)                                         # (N, B)

    # u_j = e_{2j} for valid slots: "sum_j u_j" is the even-slot indicator.
    sum_u = torch.zeros((n, g), dtype=dt, device=dev)
    sum_u[:, 0::2] = valid
    mask4 = sum_u

    h_nb = h[nbr_idx] * valid[..., None]                            # (N, B, d)

    def raw(i, shape):
        # Drawn one at a time, in the order mask1, mask2, mask3, mask5, and
        # dropped once used: a single (N, d, g) transient at a time.
        if masks is None:
            return torch.randn(shape, generator=gen, device=dev, dtype=dt)
        return torch.as_tensor(masks[i], dtype=dt, device=dev)

    odd = torch.zeros((n, g), dtype=dt, device=dev)
    odd[:, 1::2] = 1.0

    # sum_j h_j u_j^T : neighbour features on the even slots.
    outer_h_u = torch.zeros((n, d, g), dtype=dt, device=dev)
    outer_h_u[:, :, 0::2] = h_nb.transpose(1, 2)
    # Row-aligned term: pack row i belongs to h[i]. Sliced so callers may
    # pass extra gather-only rows past n (the serving patch path does).
    M1 = (raw(0, (n, d, g)) * odd[:, None, :]).addcmul_(h[:n, :, None], sum_u[:, None, :])
    M2 = (raw(1, (n, d, g)) * odd[:, None, :]).add_(outer_h_u)
    K1 = (raw(2, (n, g, d)) * odd[..., None]).add_(outer_h_u.transpose(1, 2))
    K3 = (raw(3, (n, g)) * odd).add_(sum_u)
    return VectorPack(M1=M1, M2=M2, K1=K1, K3=K3, mask4=mask4)


def vector_series(
    pack: VectorPack,
    h: torch.Tensor,
    b1: torch.Tensor,
    b2: torch.Tensor,
    coeffs: torch.Tensor,
    *,
    basis: str = "power",
    domain: Tuple[float, float] = (-4.0, 4.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (S_E: (H, N, d), S_F: (H, N)) — series-weighted moments."""
    D = torch.matmul(b1, pack.M1) + torch.matmul(b2, pack.M2)        # (N, H, g)
    mask4 = pack.mask4[:, None, :]
    R = D * mask4
    s = eval_series(torch.as_tensor(coeffs, dtype=R.dtype, device=R.device), R, basis, domain)
    s = s * mask4                           # n=0 term only on valid slots
    SE = torch.matmul(s, pack.K1)                                   # (N, H, d)
    SF = torch.matmul(s, pack.K3[:, :, None])[..., 0]               # (N, H)
    return SE.transpose(0, 1), SF.transpose(0, 1)


def fedgat_layer_vector(
    params: Params,
    pack: VectorPack,
    h: torch.Tensor,
    coeffs: torch.Tensor,
    *,
    basis: str = "power",
    domain: Tuple[float, float] = (-4.0, 4.0),
    concat: bool = True,
) -> torch.Tensor:
    """Approximate first-layer GAT update, Vector FedGAT engine."""
    b1, b2 = head_projections(params)
    SE, SF = vector_series(pack, h, b1, b2, coeffs, basis=basis, domain=domain)
    return aggregate(params, SE, SF, h.shape[0], concat)
