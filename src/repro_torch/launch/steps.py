"""Step builders shared by the train and serve CLIs (the port of
``repro/launch/steps.py``'s single-device steps): the train step (loss,
grads, clipping, AdamW), the prefill step and the decode step.

The sharded step assembly (``build_sharded_step``) needs a device mesh and
is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamState, adam_update, clip_by_global_norm

LR = 3e-4
WD = 0.1


def adam_init_f32(params: Any) -> AdamState:
    """Adam moments in float32 whatever the (bf16) param dtype: the
    production mixed-precision layout. After the first update the params
    are float32 too, as in the reference."""
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device)  # noqa: E731
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def value_and_grad(loss_fn, params: Any, batch: Dict) -> Tuple[torch.Tensor, Dict, Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)``: the
    loss, its parts and a gradient tree in the params' dtypes (zeros for a
    leaf the loss does not reach)."""
    xs = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, parts = loss_fn(tree_unflatten(params, xs), batch)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, xs)]
    parts = {k: v.detach() for k, v in parts.items()}
    return loss.detach(), parts, tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, microbatches: int = 1):
    """loss + grad + clip + AdamW. ``microbatches > 1`` accumulates grads
    over that many slices of the batch's axis 0 (summed in the params'
    dtypes, then divided), shrinking the live activations by the same
    factor. Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, loss)``."""
    model = build_model(cfg)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, _, grads = value_and_grad(model.loss, params, batch)
        else:
            def split(x, i):
                n = x.shape[0] // microbatches
                return x[i * n:(i + 1) * n]

            gsum = tree_map(torch.zeros_like, params)
            lsum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            for i in range(microbatches):
                mbatch = {k: split(v, i) for k, v in batch.items()}
                lv, _, g = value_and_grad(model.loss, params, mbatch)
                gsum = tree_map(torch.add, gsum, g)
                lsum = lsum + lv
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
        grads = clip_by_global_norm(grads, 1.0)
        new_params, new_opt = adam_update(grads, opt_state, params, LR, weight_decay=WD)
        return new_params, new_opt, loss

    return train_step


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    model = build_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        b = dict(batch)
        b["cache_len"] = cache_len
        return model.prefill(params, b)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    model = build_model(cfg)

    @torch.no_grad()
    def decode_step(params, cache, token):
        return model.decode_step(params, cache, token)

    return decode_step
