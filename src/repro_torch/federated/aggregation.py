"""Parameter aggregation over stacked client trees (paper §4: FedAvg by
default; FedProx and server-side FedAdam as the paper allows).

The port of ``repro/federated/aggregation.py``: every leaf of a stacked
tree has a leading client axis. Cohort streaming (federated/cohort.py)
never stacks a whole round: it carries a :class:`RunningAggregate`, the
weighted sum of the client params plus the weight total, so the finished
running mean equals :func:`fedavg` of the stacked params up to float
re-association.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch._tree import tree_leaves, tree_map
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


class RunningAggregate(NamedTuple):
    """Streaming weighted-mean state: Σ w_i · p_i and Σ w_i."""

    sum: Tree               # Σ w_i · p_i, same structure as one client's params
    weight: torch.Tensor    # Σ w_i, float32 scalar


@torch.no_grad()
def running_init(template: Tree) -> RunningAggregate:
    """Zero aggregate shaped like one client's params."""
    device = tree_leaves(template)[0].device
    return RunningAggregate(
        sum=tree_map(torch.zeros_like, template),
        weight=torch.zeros((), dtype=torch.float32, device=device),
    )


@torch.no_grad()
def running_update(
    state: RunningAggregate,
    stacked_params: Tree,
    weights: torch.Tensor,
    scale: Union[torch.Tensor, float] = 1.0,
) -> RunningAggregate:
    """Fold one cohort (leading axis C) in: sum += scale·Σ w_c p_c.

    ``weights`` is (C,): zero entries contribute exactly nothing. ``scale``
    is the cohort's staleness weight λ (1 in sync mode); it multiplies the
    cohort's params and its weight mass, so the finished mean is
    Σ λ w p / Σ λ w.
    """
    w = (torch.as_tensor(weights, dtype=torch.float32, device=state.weight.device)
         * torch.as_tensor(scale, dtype=torch.float32, device=state.weight.device))
    return RunningAggregate(
        sum=tree_map(lambda acc, p: acc + torch.tensordot(w.to(p.dtype), p, dims=([0], [0])),
                     state.sum, stacked_params),
        weight=state.weight + torch.sum(w),
    )


@torch.no_grad()
def running_mean(state: RunningAggregate) -> Tree:
    """The finished aggregate: Σ w p / Σ w (== fedavg of the stream)."""
    return tree_map(lambda s: s / state.weight.to(s.dtype), state.sum)


def staleness_weight(staleness, power: float) -> torch.Tensor:
    """Polynomial staleness discount λ(s) = (1 + s)^(-power) (FedAsync /
    FedBuff style); ``power=0`` is the identity."""
    s = torch.as_tensor(staleness, dtype=torch.float32)
    return (1.0 + s) ** (-float(power))


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
