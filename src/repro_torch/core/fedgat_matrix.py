"""Matrix FedGAT — the paper's main algorithm (§4, Algorithms 1 and 2).

The port of ``repro/core/fedgat_matrix.py``. Server-side pre-training pack
(per node i, padded max degree B, g = 2B):

* orthonormal pairs {u1_j, u2_j} (columns of a random orthogonal matrix),
* projectors  U_j = 1/2 (u1 u1^T + u2 u2^T + r u1 u2^T + (1/r) u2 u1^T),
  which satisfy U_j^2 = U_j and U_j U_k = 0 for j != k,
* P_i  = sum_j U_j                      (g, g)   [M1_i(s) = h_i(s) P_i]
* M2_i(s) = sum_j h_j(s) U_j            (d, g, g)
* K1_i = sqrt(2) sum_j u1_j             (g,)
* K2_i = sqrt(2) sum_j u1_j h_j^T       (g, d)

Client-side computation (per head):

  D_i = (b1.h_i) P_i + sum_s b2(s) M2_i(s)                      (Eq. 14)
  E_i^(n) = (K1^T D^n K2)^T,  F_i^(n) = K1^T D^n K1             (Eq. 12)

evaluated with the vector recurrence v_n = D^T v_{n-1}, v_0 = P^T K1, in
the paper's monomial basis or the Chebyshev basis (C_0 = P, C_1 = D/R,
C_{n+1} = 2 (D/R) C_n - C_{n-1}).

Every contraction is a batched matmul over nodes, so the largest tensor,
M2 (N, d, g, g), is read in place and never permuted into a copy. D is
built node-major, (N, H, g, g), and :func:`build_D` returns it as an
(H, N, g, g) view. All of it is plain float32 PyTorch: the reference
computes it in plain ``jnp`` too, with no Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.poly_attention import head_projections

Params = Mapping[str, torch.Tensor]


class FedGATPack(NamedTuple):
    """Pre-training communication payload for all nodes (stacked)."""

    P: torch.Tensor      # (N, g, g)    sum_j U_j  (carries M1 via h_i(s) * P)
    M2: torch.Tensor     # (N, d, g, g) sum_j h_j(s) U_j
    K1: torch.Tensor     # (N, g)
    K2: torch.Tensor     # (N, g, d)
    r: float             # obfuscation constant used in U_j


def make_projectors(
    gen: Optional[torch.Generator],
    nbr_mask: torch.Tensor,
    r: float,
    *,
    q: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-node orthonormal pairs and projectors.

    nbr_mask: (N, B) validity. ``q`` (N, g, g) is used as the orthogonal
    matrices when given; otherwise they are the QR factors of a normal
    draw from ``gen`` on the mask's device. Returns (U, u1, u2):
    U (N, B, g, g), u1/u2 (N, B, g) with invalid slots zeroed, g = 2B.
    """
    n, b = nbr_mask.shape
    g = 2 * b
    if q is None:
        normal = torch.randn((n, g, g), generator=gen, device=nbr_mask.device)
        q = torch.linalg.qr(normal)[0]                 # (N, g, g) orthogonal
    u1 = q[:, :, 0::2].transpose(1, 2)                 # (N, B, g)
    u2 = q[:, :, 1::2].transpose(1, 2)
    valid = nbr_mask[..., None].to(u1.dtype)
    u1 = u1 * valid
    u2 = u2 * valid
    # u1 u1^T + r u1 u2^T = u1 (u1 + r u2)^T, and likewise for u2: two
    # outer products accumulated into one (N, B, g, g) buffer.
    U = torch.mul(u1[..., :, None], (u1 + r * u2)[..., None, :])
    U.addcmul_(u2[..., :, None], (u2 + (1.0 / r) * u1)[..., None, :])
    U.mul_(0.5)
    return U, u1, u2


def precompute_pack(
    gen: Optional[torch.Generator],
    h: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    r: float = 1.7,
    *,
    q: Optional[torch.Tensor] = None,
) -> FedGATPack:
    """Algorithm 1: the server computes the pack from raw features."""
    U, u1, _ = make_projectors(gen, nbr_mask, r, q=q)
    n, b, g, _ = U.shape
    h_nb = h[nbr_idx] * nbr_mask[..., None].to(h.dtype)         # (N, B, d)
    d = h_nb.shape[-1]
    P = U.sum(dim=1)                                            # (N, g, g)
    M2 = torch.matmul(h_nb.transpose(1, 2), U.view(n, b, g * g)).view(n, d, g, g)
    del U
    K1 = math.sqrt(2.0) * u1.sum(dim=1)                         # (N, g)
    K2 = math.sqrt(2.0) * torch.matmul(u1.transpose(1, 2), h_nb)  # (N, g, d)
    return FedGATPack(P=P, M2=M2, K1=K1, K2=K2, r=r)


def build_D(
    pack: FedGATPack, h: torch.Tensor, b1: torch.Tensor, b2: torch.Tensor
) -> torch.Tensor:
    """D_i per head (Eq. 14). b1/b2: (H, d). -> (H, N, g, g), a view of a
    node-major (N, H, g, g) tensor."""
    n, d, g, _ = pack.M2.shape
    s1 = torch.matmul(h[:n], b1.t())                            # (N, H): b1 . h_i
    D = torch.matmul(b2, pack.M2.view(n, d, g * g)).view(n, -1, g, g)  # (N, H, g, g)
    D.addcmul_(s1[:, :, None, None], pack.P[:, None])           # in place: no second D
    return D.transpose(0, 1)


def series_moments(
    pack: FedGATPack,
    D: torch.Tensor,
    coeffs: torch.Tensor,
    *,
    basis: str = "power",
    domain: Tuple[float, float] = (-4.0, 4.0),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """sum_n c_n E^(n), sum_n c_n F^(n) via the v-recurrence.

    D: (H, N, g, g). Returns (S_E: (H, N, d), S_F: (H, N)). The
    coefficients stay on the device: each step scales by a 0-d tensor.
    """
    coeffs = torch.as_tensor(coeffs, dtype=D.dtype, device=D.device)
    Dn = D.transpose(0, 1)                                      # (N, H, g, g)
    K1 = pack.K1[:, :, None]                                    # (N, g, 1)
    v0 = torch.matmul(pack.K1[:, None, :], pack.P)              # P^T K1: (N, 1, g)
    v0 = v0.expand(-1, Dn.shape[1], -1)                         # (N, H, g)

    def em(v):  # E-moment contribution  K2^T v: (N, H, d)
        return torch.matmul(v, pack.K2)

    def fm(v):  # F-moment contribution  K1 . v: (N, H)
        return torch.matmul(v, K1)[..., 0]

    def step(v):  # v <- D^T v
        return torch.matmul(v[..., None, :], Dn)[..., 0, :]

    if basis == "power":
        p1 = coeffs.shape[0]
        v = v0
        SE = coeffs[0] * em(v)
        SF = coeffs[0] * fm(v)
        for n in range(1, p1):
            v = step(v)
            SE = SE + coeffs[n] * em(v)
            SF = SF + coeffs[n] * fm(v)
        return SE.transpose(0, 1), SF.transpose(0, 1)

    if basis == "chebyshev":
        lo, hi = domain
        if abs(lo + hi) > 1e-9:
            raise ValueError("chebyshev basis assumes symmetric domain")
        R = hi
        SE = coeffs[0] * em(v0)
        SF = coeffs[0] * fm(v0)
        w_prev, w = v0, step(v0) / R
        for n in range(1, coeffs.shape[0]):
            SE = SE + coeffs[n] * em(w)
            SF = SF + coeffs[n] * fm(w)
            if n + 1 < coeffs.shape[0]:
                w_prev, w = w, 2.0 * (step(w) / R) - w_prev
        return SE.transpose(0, 1), SF.transpose(0, 1)

    raise ValueError(f"unknown basis {basis!r}")


def aggregate(params: Params, SE: torch.Tensor, SF: torch.Tensor, n: int,
              concat: bool) -> torch.Tensor:
    """Eq. 7 from the series moments: SE/SF per head, projected by W.
    Isolated nodes have all-zero pack slots, so both moments are exactly
    zero: they aggregate to zero instead of 0/0 NaN (the guard of the
    direct and kernel engines)."""
    ok = SF[..., None] != 0
    agg = torch.where(ok, SE / torch.where(ok, SF[..., None], 1.0), 0.0)  # (H, N, d_in)
    out = torch.matmul(agg, params["W"])                                 # (H, N, d_out)
    if concat:
        return out.transpose(0, 1).reshape(n, -1)
    return out.mean(dim=0)


def fedgat_layer_matrix(
    params: Params,
    pack: FedGATPack,
    h: torch.Tensor,
    coeffs: torch.Tensor,
    *,
    basis: str = "power",
    domain: Tuple[float, float] = (-4.0, 4.0),
    concat: bool = True,
) -> torch.Tensor:
    """Approximate first-layer GAT update from the communicated pack (Eq. 7)."""
    b1, b2 = head_projections(params)
    D = build_D(pack, h, b1, b2)
    SE, SF = series_moments(pack, D, coeffs, basis=basis, domain=domain)
    return aggregate(params, SE, SF, h.shape[0], concat)
