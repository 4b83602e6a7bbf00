"""Adam/AdamW on parameter trees (nested lists/dicts of tensors).

The port of ``repro/optim/adamw.py::adam_init``/``adam_update`` in the
reference's exact form ``p - lr * (mhat / (sqrt(vhat) + eps) + wd * p)``,
with an int32 step count cast to float32 for the bias corrections,
``clip_by_global_norm`` (DP clipping and the LM train step) and
``sgd_update``. As in the reference, a bfloat16 leaf updated with float32
moments comes back float32.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map

Tree = Any


class AdamState(NamedTuple):
    step: torch.Tensor      # int32 scalar (a leading client axis in a bank)
    mu: Tree
    nu: Tree


def adam_init(params: Tree) -> AdamState:
    device = tree_leaves(params)[0].device
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(torch.zeros_like, params),
        nu=tree_map(torch.zeros_like, params),
    )


@torch.no_grad()
def adam_update(
    grads: Tree,
    state: AdamState,
    params: Tree,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Tuple[Tree, AdamState]:
    step = state.step + 1
    t = step.to(torch.float32)
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
    bc1 = 1 - b1 ** t
    bc2 = 1 - b2 ** t

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        return p - lr * (mhat / (torch.sqrt(vhat) + eps) + weight_decay * p)

    return tree_map(upd, params, mu, nu), AdamState(step=step, mu=mu, nu=nu)


@torch.no_grad()
def sgd_update(grads: Tree, params: Tree, lr: float) -> Tree:
    return tree_map(lambda p, g: p - lr * g, params, grads)


@torch.no_grad()
def clip_by_global_norm(grads: Tree, max_norm: float, norm: torch.Tensor = None) -> Tree:
    """Scale every leaf by ``min(1, max_norm / max(||grads||_2, 1e-12))``,
    the global norm taken over all leaves in float32 (or ``norm``, when the
    caller reckons it: a sharded step sums its blocks' squares over ranks)."""
    if norm is None:
        norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    # jnp promotes a bf16 leaf times the float32 scale to float32 before the
    # cast back; torch would round the 0-d scale to the leaf's dtype first.
    return tree_map(
        lambda g: (g.to(torch.promote_types(g.dtype, scale.dtype)) * scale).to(g.dtype), grads)
