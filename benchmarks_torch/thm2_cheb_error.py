"""Theorem 2: truncated-Chebyshev sup-norm error of the attention score
function vs degree; the measured error must decay and respect the k=1
regularity of exp(LeakyReLU) (derivative kink at 0).

The port of ``benchmarks/thm2_cheb_error.py``: numpy only, so its rows are
the reference's bit for bit and ``device`` moves nothing.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core import chebyshev as C

DOMAIN = (-4.0, 4.0)


def run(fast: bool = False, device=None) -> List[Dict]:
    degrees = (4, 8, 16, 32) if fast else (4, 8, 12, 16, 24, 32, 48, 64)
    rows = []
    for p in degrees:
        cc = C.chebyshev_coeffs(C.default_score_fn, p, DOMAIN)
        err = C.empirical_sup_error(C.default_score_fn, cc, DOMAIN)
        rows.append({"degree": p, "sup_error": err,
                     "error_x_p": err * p})  # ~constant if O(1/p)
    # analytic reference: exp alone (smooth) converges geometrically
    for p in (8, 16):
        cc = C.chebyshev_coeffs(np.exp, p, (-1, 1))
        rows.append({"degree": p, "sup_error": C.empirical_sup_error(np.exp, cc, (-1, 1)),
                     "function": "exp_smooth"})
    return rows


def derived(rows: List[Dict]) -> str:
    main = [r for r in rows if "function" not in r]
    first, last = main[0], main[-1]
    return (f"err@p{first['degree']}={first['sup_error']:.4f} "
            f"err@p{last['degree']}={last['sup_error']:.4f} "
            f"decay={first['sup_error']/last['sup_error']:.1f}x")
