"""repro_torch.privacy — differential privacy and secure aggregation for
the port's Trainer, with the reference's names (``repro.privacy``):

  * privacy/dp.py         — DP-FedAvg client-update clipping and Gaussian
                            noise, applied at the end of ``make_local_update``;
  * privacy/accountant.py — the RDP accountant of the per-round sampled
                            Gaussian mechanism (a copy of the reference's);
  * privacy/secure_agg.py — secure aggregation: the multi-party protocol
                            (``secure_agg_mode="protocol"``, host numpy,
                            bit for bit the reference's) and the pairwise
                            PRF masks (``"pairwise"``, torch generators);
  * privacy/shamir.py     — t-of-n secret sharing for the protocol's
                            dropout recovery (a copy);
  * privacy/pack_dp.py    — calibrated one-shot noise on the
                            pre-communicated FedGAT pack;
  * privacy/attacks/      — the node membership-inference audit.

The reference's PRF streams (DP noise, pairwise masks, pack noise) come
from ``jax.random``, which torch cannot reproduce: the port derives 64-bit
seeds under the same domain-separation constants and draws from explicit
``torch.Generator``s. :func:`privacy_report` is the result-schema hook of
``build_result``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

from repro_torch.privacy.accountant import (
    DEFAULT_ORDERS,
    RdpAccountant,
    compute_epsilon,
    rdp_sampled_gaussian,
    rdp_to_epsilon,
    sensitivity_factor,
)
from repro_torch.privacy.config import DP_GRANULARITIES, SECURE_AGG_MODES, PrivacyConfig
from repro_torch.privacy.dp import (
    client_round_key,
    make_dp_transform,
    mask_base_key,
    noise_base_key,
    pack_noise_key,
    per_client_noise_std,
    tree_add_normal,
)
from repro_torch.privacy.pack_dp import (
    feature_norm_bound,
    node_influence_bound,
    noisy_pack,
    pack_release_steps,
    pack_sensitivities,
    projector_norm,
)
from repro_torch.privacy.secure_agg import (
    DropoutRecoveryError,
    SecureAggRound,
    add_client_mask,
    client_mask,
    flatten_pytree,
    pair_key,
    quantization_step,
)

__all__ = [
    "PrivacyConfig",
    "DP_GRANULARITIES",
    "SECURE_AGG_MODES",
    "RdpAccountant",
    "DEFAULT_ORDERS",
    "compute_epsilon",
    "rdp_sampled_gaussian",
    "rdp_to_epsilon",
    "sensitivity_factor",
    "client_round_key",
    "make_dp_transform",
    "mask_base_key",
    "noise_base_key",
    "pack_noise_key",
    "per_client_noise_std",
    "tree_add_normal",
    "noisy_pack",
    "pack_release_steps",
    "pack_sensitivities",
    "feature_norm_bound",
    "node_influence_bound",
    "projector_norm",
    "DropoutRecoveryError",
    "SecureAggRound",
    "flatten_pytree",
    "quantization_step",
    "add_client_mask",
    "client_mask",
    "pair_key",
    "privacy_report",
]


def privacy_report(
    priv: PrivacyConfig,
    *,
    rounds: int,
    num_clients: int,
    num_selected: int,
    pack_released: bool = True,
    node_influence: Optional[int] = None,
) -> Dict[str, Any]:
    """The serializable privacy summary stored in every Trainer result.

    ``epsilon`` is the client-level (ε, δ=priv.delta) of the whole training
    run *at the aggregate* — the mechanism whose noise std is σ·clip on the
    sum of clipped deltas: None when the DP mechanism is off entirely, ∞
    when updates are clipped but unnoised, finite when the sampled
    Gaussian mechanism ran. Each client only adds its 1/sqrt(n_sel) noise
    share locally (privacy/dp.py), so that figure holds against every
    party only under ``secure_agg=True`` (the server never sees an
    individual update); with secure aggregation off it is the
    trusted-aggregator guarantee of the released aggregate, and
    ``epsilon_vs_server`` reports the weaker guarantee an honest-but-
    curious server observing individual updates (effective multiplier
    σ/sqrt(n_sel)) actually gets. ``trust_model`` names which regime
    applies. ``pack_epsilon`` accounts the one-shot pack release
    separately, and only when a pack was actually released
    (``pack_released`` — the Trainer passes this; packless methods/engines
    are rejected at config time).

    ``dp_granularity="node"`` reports all three epsilons for the
    node-substitution unit of protection instead of the client-level one:
    update epsilons pay the factor-2 substitution sensitivity
    (accountant.sensitivity_factor) and the pack epsilon pays the
    node-influence bound (``node_influence``, from
    pack_dp.node_influence_bound on the degree-capped graph — the Trainer
    passes it; required whenever pack noise is accounted at node level).
    """
    priv.validate()
    q = num_selected / max(num_clients, 1)
    sens = sensitivity_factor(priv.dp_granularity)
    if not priv.dp_enabled:
        epsilon = epsilon_vs_server = None
    elif priv.noise_multiplier <= 0:
        epsilon = epsilon_vs_server = math.inf
    else:
        epsilon = compute_epsilon(
            priv.noise_multiplier, rounds, q, priv.delta, sensitivity=sens
        )
        epsilon_vs_server = (
            epsilon
            if priv.secure_agg
            else compute_epsilon(
                priv.noise_multiplier / math.sqrt(max(num_selected, 1)),
                rounds, q, priv.delta, sensitivity=sens,
            )
        )
    # The pack release is a JOINT mechanism: one neighbour's data shifts
    # every noised tensor, so the accountant composes one Gaussian step
    # per tensor (4 for both pack types), not a single step.
    if priv.pack_noise_multiplier > 0 and pack_released:
        pack_sens = 1.0
        if priv.dp_granularity == "node":
            if node_influence is None:
                raise ValueError(
                    "dp_granularity='node' with pack noise requires "
                    "node_influence (see pack_dp.node_influence_bound)"
                )
            pack_sens = float(node_influence)
        pack_epsilon = compute_epsilon(
            priv.pack_noise_multiplier,
            pack_release_steps(),
            1.0,
            priv.delta,
            sensitivity=pack_sens,
        )
    else:
        pack_epsilon = None
    return {
        "enabled": priv.enabled,
        "mechanism": "dp-fedavg/sgm-rdp",
        "noise_multiplier": priv.noise_multiplier,
        "clip": priv.clip,
        "secure_agg": priv.secure_agg,
        "secure_agg_mode": priv.secure_agg_mode if priv.secure_agg else None,
        "trust_model": "secure-agg" if priv.secure_agg else "trusted-aggregator",
        "pack_noise_multiplier": priv.pack_noise_multiplier,
        "delta": priv.delta,
        "sampling_rate": q,
        "rounds": rounds,
        "dp_granularity": priv.dp_granularity,
        "node_influence": node_influence,
        "epsilon": epsilon,
        "epsilon_vs_server": epsilon_vs_server,
        "pack_epsilon": pack_epsilon,
    }
