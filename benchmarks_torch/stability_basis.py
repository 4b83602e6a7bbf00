"""Beyond-paper: numerical stability of the monomial (power) basis the
paper uses (Eq. 6) vs the Chebyshev-basis federated evaluation, as the
truncation degree grows. The cheb->monomial conversion is exponentially
ill-conditioned; the projector algebra supports the stable three-term
recurrence directly (core/fedgat_matrix.py).

The port of ``benchmarks/stability_basis.py``. The params come from the
port's ``init_params`` under ``torch.Generator().manual_seed(seed)``;
:func:`_rows` takes any params (the reference's included).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import FedGATConfig, gat_layer_nbr, init_params, poly_gat_layer
from repro_torch.core.fedgat_model import graph_tensors
from repro_torch.graphs import make_cora_like


def run(fast: bool = False, seed: int = 0, device=None) -> List[Dict]:
    dev = resolve_device(device)
    g = make_cora_like("tiny", seed=seed)
    params = init_params(torch.Generator().manual_seed(seed), g.feature_dim,
                         g.num_classes, FedGATConfig(), device=dev)
    return _rows(fast, g, params, dev)


@torch.no_grad()
def _rows(fast: bool, g, params, dev: torch.device) -> List[Dict]:
    degrees = (16, 32) if fast else (8, 16, 32, 48, 64)
    h, nbr_idx, nbr_mask = graph_tensors(g, dev)
    exact = gat_layer_nbr(params[0], h, nbr_idx, nbr_mask, concat=True)
    rows = []
    for p in degrees:
        row = {"degree": p}
        for basis in ("power", "chebyshev"):
            cfg = FedGATConfig(degree=p, basis=basis)
            coeffs = torch.as_tensor(cfg.coeffs(), dtype=torch.float32, device=dev)
            out = poly_gat_layer(params[0], coeffs, h, nbr_idx, nbr_mask,
                                 basis=basis, domain=cfg.domain)
            err = float(torch.max(torch.abs(out - exact)))
            row[f"err_{basis}"] = err if np.isfinite(err) else float("inf")
            # conditioning probe: max |coefficient|
            row[f"coeff_max_{basis}"] = float(np.max(np.abs(cfg.coeffs())))
        rows.append(row)
    return rows


def derived(rows: List[Dict]) -> str:
    last = rows[-1]
    return (f"p={last['degree']}: power_err={last['err_power']:.3g} "
            f"cheb_err={last['err_chebyshev']:.3g} "
            f"power_coeff_max={last['coeff_max_power']:.2g}")
