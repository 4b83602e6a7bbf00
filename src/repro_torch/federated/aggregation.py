"""Parameter aggregation over stacked client trees (paper §4: FedAvg by
default; FedProx and server-side FedAdam as the paper allows).

The port of ``repro/federated/aggregation.py``: every leaf of a stacked
tree has a leading client axis. The ``RunningAggregate`` family and
``staleness_weight`` wait for the cohort slice.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch._tree import tree_map
from repro_torch.optim.adamw import AdamState

Tree = Any


@torch.no_grad()
def fedavg(stacked_params: Tree, weights: Optional[torch.Tensor] = None) -> Tree:
    """Weighted mean over the leading client axis (McMahan et al. 2017)."""
    if weights is None:
        return tree_map(lambda p: torch.mean(p, dim=0), stacked_params)
    w = weights / torch.sum(weights)
    return tree_map(
        lambda p: torch.tensordot(w.to(p.dtype), p, dims=([0], [0])), stacked_params
    )


@torch.no_grad()
def fedprox_grad(local_params: Tree, global_params: Tree, grads: Tree, mu: float) -> Tree:
    """FedProx (Li et al. 2020): add mu * (W_k - W_global) to local grads."""
    return tree_map(lambda g, p, gp: g + mu * (p - gp), grads, local_params, global_params)


@torch.no_grad()
def fedadam_update(
    global_params: Tree,
    mean_params: Tree,
    opt_state: AdamState,
    server_lr: float = 0.05,
    b1: float = 0.9,
    b2: float = 0.99,
    eps: float = 1e-6,
) -> Tuple[Tree, AdamState]:
    """Server-side Adam step on the pseudo-gradient
    Delta = W_global - mean_k(W_k), given the aggregated client mean."""
    delta = tree_map(lambda gp, m: gp - m, global_params, mean_params)
    step = opt_state.step + 1
    t = step.to(torch.float32)
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, opt_state.mu, delta)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, opt_state.nu, delta)

    def upd(p, m, v):
        mhat = m / (1 - b1 ** t)
        vhat = v / (1 - b2 ** t)
        return p - server_lr * mhat / (torch.sqrt(vhat) + eps)

    return tree_map(upd, global_params, mu, nu), AdamState(step=step, mu=mu, nu=nu)


def fedadam_server(
    global_params: Tree,
    stacked_params: Tree,
    opt_state: AdamState,
    server_lr: float = 0.05,
    b1: float = 0.9,
    b2: float = 0.99,
    eps: float = 1e-6,
    weights: Optional[torch.Tensor] = None,
) -> Tuple[Tree, AdamState]:
    """FedAdam (Reddi et al. 2020): Adam on the pseudo-gradient
    Delta = W_global - mean_k(W_k)."""
    mean = fedavg(stacked_params, weights=weights)
    return fedadam_update(global_params, mean, opt_state, server_lr, b1=b1, b2=b2, eps=eps)
