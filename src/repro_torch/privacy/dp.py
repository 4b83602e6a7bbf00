"""DP-FedAvg client-update privatisation (McMahan et al. 2018).

The port of ``repro/privacy/dp.py``. The mechanism is a transform of one
client's local update delta ``W_local - W_global`` at the end of its local
phase:

  1. clip the delta to L2 norm ``clip`` (the contribution bound), then
  2. add Gaussian noise ``N(0, (σ · clip / sqrt(n_sel))² I)`` per client,

so the sum over the ``n_sel`` participants carries noise of std ``σ ·
clip``: the sampled Gaussian mechanism the accountant composes.

The reference derives its streams with ``jax.random.fold_in``; torch
cannot reproduce those bits, so here every key is a 64-bit seed derived
with :func:`repro_torch._rng.fold_in` under the reference's constants, and
each draw comes from an explicit ``torch.Generator`` seeded with it. The
client-update noise is drawn on a CPU generator and moved to the
parameters' device (a few thousand floats a client), so a run on the card
and the same run on the CPU add the same noise.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

from repro_torch._rng import fold_in, generator
from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim.adamw import clip_by_global_norm
from repro_torch.privacy.config import PrivacyConfig

Tree = Any

# Domain-separation constants of the reference: the privacy streams never
# overlap the pack and init streams.
_PRIVACY_STREAM = 0x0DDD5EED
_NOISE_SUBSTREAM = 0
_MASK_SUBSTREAM = 1
_PACK_SUBSTREAM = 2


def privacy_base_key(seed: int) -> int:
    """Root seed of the privacy streams for a run seed."""
    return fold_in(seed, _PRIVACY_STREAM)


def noise_base_key(seed: int) -> int:
    return fold_in(privacy_base_key(seed), _NOISE_SUBSTREAM)


def mask_base_key(seed: int) -> int:
    return fold_in(privacy_base_key(seed), _MASK_SUBSTREAM)


def pack_noise_key(seed: int) -> int:
    return fold_in(privacy_base_key(seed), _PACK_SUBSTREAM)


def client_round_key(base: int, round_idx: int, client_id: int) -> int:
    """Per-(round, client) seed; the same on every device and backend."""
    return fold_in(fold_in(base, round_idx), client_id)


@torch.no_grad()
def tree_add_normal(key: int, tree: Tree, std: float) -> Tree:
    """tree + N(0, std² I): leaf ``i`` draws from a CPU generator seeded
    ``fold_in(key, i)``, and the draw moves to the leaf's device."""
    leaves = tree_leaves(tree)
    noised = [
        leaf + std * torch.randn(leaf.shape, generator=generator(fold_in(key, i)),
                                 dtype=leaf.dtype).to(leaf.device)
        for i, leaf in enumerate(leaves)
    ]
    return tree_unflatten(tree, noised)


def per_client_noise_std(priv: PrivacyConfig, num_selected: int) -> float:
    """Each client's 1/sqrt(n_sel) share of the σ·clip sum-level noise."""
    if priv.noise_multiplier <= 0:
        return 0.0
    return priv.noise_multiplier * priv.clip / math.sqrt(max(num_selected, 1))


def make_dp_transform(
    priv: PrivacyConfig, num_selected: int
) -> Callable[[int, Tree, Tree], Tree]:
    """The per-client privatisation ``(seed, W_global, W_local) -> W_dp``.

    Returns ``W_global + noise(clip(W_local - W_global))``. With
    ``noise_multiplier=0`` only the clip runs; callers gate on
    ``priv.dp_enabled`` so the identity config adds no ops at all.
    """
    priv.validate()
    std = per_client_noise_std(priv, num_selected)

    @torch.no_grad()
    def transform(seed: int, gparams: Tree, params: Tree) -> Tree:
        delta = tree_map(torch.subtract, params, gparams)
        if math.isfinite(priv.clip):
            delta = clip_by_global_norm(delta, priv.clip)
        if std > 0:
            delta = tree_add_normal(seed, delta, std)
        return tree_map(torch.add, gparams, delta)

    return transform
