"""Theorems 3-5: empirical error propagation — attention-score error eps ->
attention-coefficient error (Thm 3) -> layer-1 embedding error (Thm 4) ->
final-logit error across layers (Thm 5), as a function of degree p.

The port of ``benchmarks/thm35_error_prop.py``. The params come from the
port's ``init_params`` under ``torch.Generator().manual_seed(seed)``;
:func:`_rows` takes any params (the reference's included).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch._device import resolve_device
from repro_torch.core import FedGAT, FedGATConfig, gat_layer_nbr, init_params, poly_gat_layer
from repro_torch.core.fedgat_model import graph_tensors
from repro_torch.core.poly_attention import edge_scores, eval_series, head_projections
from repro_torch.graphs import make_cora_like

DOMAIN = (-4.0, 4.0)


def run(fast: bool = False, seed: int = 0, device=None) -> List[Dict]:
    dev = resolve_device(device)
    g = make_cora_like("tiny", seed=seed)
    params = init_params(torch.Generator().manual_seed(seed), g.feature_dim,
                         g.num_classes, FedGATConfig(), device=dev)
    return _rows(fast, g, params, dev)


@torch.no_grad()
def _rows(fast: bool, g, params, dev: torch.device) -> List[Dict]:
    degrees = (8, 16) if fast else (6, 10, 16, 24, 32)
    h, nbr_idx, nbr_mask = graph_tensors(g, dev)
    b1, b2 = head_projections(params[0])
    x = edge_scores(b1, b2, h, nbr_idx)
    e_exact = torch.exp(torch.where(x >= 0, x, 0.2 * x))
    mask = nbr_mask[None].to(torch.float32)

    logits_exact = FedGAT(FedGATConfig(engine="exact"), device=dev).apply(params, g)
    layer_exact = gat_layer_nbr(params[0], h, nbr_idx, nbr_mask, concat=True)

    rows = []
    for p in degrees:
        model = FedGAT(FedGATConfig(degree=p, basis="chebyshev", engine="direct"), device=dev)
        coeffs = model.coeffs
        e_hat = eval_series(coeffs, x, "chebyshev", DOMAIN)
        eps = float(torch.max(torch.abs(e_hat - e_exact) * mask))

        alpha = (e_exact * mask) / torch.sum(e_exact * mask, -1, keepdim=True)
        alpha_hat = (e_hat * mask) / torch.sum(e_hat * mask, -1, keepdim=True)
        alpha_err = float(torch.max(torch.abs(alpha_hat - alpha)))
        thm3_bound = 2 * eps / (1 - eps) if eps < 1 else float("inf")

        layer_hat = poly_gat_layer(params[0], coeffs, h, nbr_idx, nbr_mask,
                                   basis="chebyshev", domain=DOMAIN)
        layer_err = float(torch.max(torch.linalg.norm(
            (layer_hat - layer_exact).reshape(g.num_nodes, -1), dim=-1)))

        logits = model.apply(params, g)
        logit_err = float(torch.max(torch.abs(logits - logits_exact)))

        rows.append({"degree": p, "eps_score": eps, "alpha_err": alpha_err,
                     "thm3_bound": thm3_bound, "layer1_err": layer_err,
                     "final_logit_err": logit_err,
                     "thm3_satisfied": alpha_err <= thm3_bound + 1e-6})
    return rows


def derived(rows: List[Dict]) -> str:
    ok = all(r["thm3_satisfied"] for r in rows)
    first, last = rows[0], rows[-1]
    return (f"thm3_bound_holds={ok} "
            f"logit_err p{first['degree']}->{last['degree']}: "
            f"{first['final_logit_err']:.4f}->{last['final_logit_err']:.4f}")
