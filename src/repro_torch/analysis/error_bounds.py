"""Closed-form error bounds from the paper's Theorems 3-5 ("Thm 3.5" chain).

The paper controls FedGAT's approximation quality through one scalar: the
attention-score error

    eps = max_ij | series(x_ij) - exp(LeakyReLU(x_ij)) |

(relative to the exact attention mass). From eps the theorems propagate:

* Theorem 3 — attention-coefficient error:
      |alpha_hat - alpha| <= alpha * 2 eps / (1 - eps)
* Theorem 4 — layer-1 embedding error (kappa-Lipschitz activation, ELU has
  kappa = 1; the multi-head concat picks up a sqrt(H) factor):
      ||h_hat - h|| <= sqrt(H) * 2 eps / (1 - eps)
* Theorem 5 — L-layer propagation: each exact-GAT layer l > 1 can at most
  double a bounded input perturbation (row-stochastic attention + unit-norm
  projections under Assumptions 2-3), so the final-logit error is
      ||z_hat - z|| <= (2 kappa)^(L-1) * sqrt(H) * 2 eps / (1 - eps).

These helpers are pure host-side math. The port keeps its own copy of
``repro/analysis/error_bounds.py``: the serving layer (repro_torch/serving)
tracks the accumulated drift of a stale pre-communicated pack against
:func:`thm35_logit_bound` and refreshes the pack when the bound is crossed.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def thm3_coefficient_bound(eps: float) -> float:
    """Theorem 3: relative attention-coefficient error from score error eps.

    Returns ``2 eps / (1 - eps)``; ``inf`` once eps >= 1 (the theorem's
    premise fails — the score error is as large as the scores themselves).
    """
    if eps < 0:
        raise ValueError(f"eps must be >= 0, got {eps}")
    if eps >= 1.0:
        return math.inf
    return 2.0 * eps / (1.0 - eps)


def thm4_layer1_bound(eps: float, heads: int, kappa: float = 1.0) -> float:
    """Theorem 4: layer-1 embedding error bound (multi-head concat)."""
    if heads < 1:
        raise ValueError(f"heads must be >= 1, got {heads}")
    return math.sqrt(heads) * kappa * thm3_coefficient_bound(eps)


def thm35_logit_bound(
    eps: float, num_layers: int, heads: int, kappa: float = 1.0
) -> float:
    """Theorem 5: final-logit error after L layers from score error eps.

    Layer 1 contributes the Theorem-4 bound; every exact layer l > 1
    amplifies it by at most ``2 kappa`` (attention rows are stochastic, the
    score perturbation enters both numerator and normaliser).
    """
    if num_layers < 1:
        raise ValueError(f"num_layers must be >= 1, got {num_layers}")
    base = thm4_layer1_bound(eps, heads, kappa)
    if math.isinf(base):
        return math.inf
    return (2.0 * kappa) ** (num_layers - 1) * base


def series_envelope(
    coeffs: np.ndarray,
    basis: str = "power",
    domain: Tuple[float, float] = (-4.0, 4.0),
    num: int = 2049,
) -> Tuple[float, float]:
    """(min, max) of |series(x)| over the fitted domain (dense grid scan).

    The serving drift tracker uses the envelope to turn "k neighbour slots
    are missing from the stale pack" into a worst-case attention-mass
    perturbation without evaluating any scores.
    """
    import torch

    from repro_torch.core.chebyshev import eval_chebyshev, eval_power_series

    # float32, as the reference evaluates it
    xs = torch.from_numpy(np.linspace(domain[0], domain[1], num, dtype=np.float32))
    c = torch.from_numpy(np.asarray(coeffs, np.float32))
    if basis == "power":
        ys = eval_power_series(c, xs)
    elif basis == "chebyshev":
        ys = eval_chebyshev(c, xs, domain)
    else:
        raise ValueError(f"unknown basis {basis!r}")
    a = np.abs(ys.numpy())
    return float(a.min()), float(a.max())
