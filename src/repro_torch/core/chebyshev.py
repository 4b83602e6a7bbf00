"""Chebyshev approximation machinery for FedGAT (paper §4, Eq. 5-6).

FedGAT approximates the attention score function

    f(x) = exp(psi(x)),   psi = LeakyReLU by default,

on a bounded domain [-R, R] with a truncated Chebyshev series of degree p,
then (in the paper) re-expresses it as a monomial power series
``e_ij ~= sum_n q_n x_ij**n`` so that the moments ``E_i^(n), F_i^(n)`` can be
computed from pre-communicated matrices.

Both evaluation bases are implemented:

* ``power``     — the paper-faithful monomial series (Eq. 6). Conversion
                  cheb->monomial is numerically delicate at high degree, so
                  coefficients are computed in float64.
* ``chebyshev`` — direct Clenshaw / matrix-Chebyshev-recurrence evaluation.
                  This is our beyond-paper numerical improvement: the
                  idempotent-projector algebra supports the three-term
                  recurrence C_{n+1} = 2*(D/R) C_n - C_{n-1} with unit
                  element P = sum_j U_j, so the stable basis works in the
                  federated computation too (see repro/core/fedgat_matrix.py).

All coefficient computation is static numpy (coefficients are constants with
respect to training), copied verbatim from ``repro/core/chebyshev.py`` so the
coefficients are bit-identical; the evaluation helpers are torch loops in the
reference's order.
"""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Score functions psi / f = exp(psi(.))
# ---------------------------------------------------------------------------

def leaky_relu_np(x: np.ndarray, slope: float = 0.2) -> np.ndarray:
    return np.where(x >= 0, x, slope * x)


def default_score_fn(x: np.ndarray, slope: float = 0.2) -> np.ndarray:
    """f(x) = exp(LeakyReLU(x)) — the GAT attention score (paper Eq. 3)."""
    return np.exp(leaky_relu_np(x, slope))


# ---------------------------------------------------------------------------
# Coefficient computation (numpy, float64)
# ---------------------------------------------------------------------------

def chebyshev_coeffs(
    fn: Callable[[np.ndarray], np.ndarray],
    degree: int,
    domain: Tuple[float, float] = (-4.0, 4.0),
) -> np.ndarray:
    """Chebyshev-basis coefficients c_n of fn on ``domain``.

    Uses interpolation at the degree+1 Chebyshev points of the first kind
    (equivalent to the DCT-based projection up to aliasing; for smooth fn the
    aliased coefficients are within Theorem-2-style bounds of the true ones).
    """
    lo, hi = domain
    n = degree + 1
    # Chebyshev points of the first kind on [-1, 1].
    k = np.arange(n, dtype=np.float64)
    t = np.cos((2 * k + 1) * np.pi / (2 * n))
    x = 0.5 * (hi - lo) * t + 0.5 * (hi + lo)
    y = np.asarray(fn(x), dtype=np.float64)
    # Discrete Chebyshev transform.
    Tkn = np.cos(np.outer(np.arange(n), (2 * k + 1) * np.pi / (2 * n)))
    c = 2.0 / n * (Tkn @ y)
    c[0] *= 0.5
    return c


def cheb_to_power(coeffs_cheb: np.ndarray, domain: Tuple[float, float]) -> np.ndarray:
    """Convert Chebyshev-basis coefficients on ``domain`` to monomial
    coefficients q_n in the *unscaled* variable x (paper Eq. 6).

    q is such that fn(x) ~= sum_n q[n] * x**n for x in domain.
    """
    lo, hi = domain
    if not np.isclose(-lo, hi):
        raise ValueError("power-series path assumes a symmetric domain")
    # Monomial coefficients in t = x / R on [-1, 1].
    q_t = np.polynomial.chebyshev.cheb2poly(np.asarray(coeffs_cheb, np.float64))
    R = hi
    scale = R ** -np.arange(len(q_t), dtype=np.float64)
    return q_t * scale


def power_series_coeffs(
    fn: Callable[[np.ndarray], np.ndarray],
    degree: int,
    domain: Tuple[float, float] = (-4.0, 4.0),
) -> np.ndarray:
    """Paper-faithful pipeline: Chebyshev fit -> monomial q_n (Eq. 5 -> 6)."""
    return cheb_to_power(chebyshev_coeffs(fn, degree, domain), domain)


def attention_series(
    degree: int,
    domain: Tuple[float, float] = (-4.0, 4.0),
    slope: float = 0.2,
    basis: str = "power",
) -> np.ndarray:
    """Series coefficients for the GAT score f = exp(LeakyReLU)."""
    fn = functools.partial(default_score_fn, slope=slope)
    if basis == "power":
        return power_series_coeffs(fn, degree, domain)
    if basis == "chebyshev":
        return chebyshev_coeffs(fn, degree, domain)
    raise ValueError(f"unknown basis {basis!r}")


# ---------------------------------------------------------------------------
# Evaluation (torch)
# ---------------------------------------------------------------------------

def eval_power_series(q, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation of sum_n q[n] x**n. q: (p+1,), x: any shape."""
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    # Horner runs from the highest coefficient down.
    acc = torch.zeros_like(x)
    for qn in q.flip(0):
        acc = acc * x + qn
    return acc


def eval_chebyshev(c, x: torch.Tensor, domain: Tuple[float, float]) -> torch.Tensor:
    """Clenshaw evaluation of sum_n c[n] T_n(t), t = scaled x. Stable."""
    lo, hi = domain
    t = (2.0 * x - (lo + hi)) / (hi - lo)
    c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for cn in c[1:].flip(0):
        b1, b2 = 2.0 * t * b1 - b2 + cn, b1
    return t * b1 - b2 + c[0]
