"""Privacy for the port: the configuration and the report of a run.

Only the identity configuration runs in the port so far: the mechanisms
of ``repro.privacy`` (DP clipping and noise with its accountant, secure
aggregation, pack noise) wait for the privacy slice, and
:func:`privacy_report` raises for a config that enables any of them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np

from repro_torch.privacy.config import DP_GRANULARITIES, SECURE_AGG_MODES, PrivacyConfig

__all__ = [
    "DP_GRANULARITIES",
    "PrivacyConfig",
    "SECURE_AGG_MODES",
    "node_influence_bound",
    "privacy_report",
]


def node_influence_bound(g: Any) -> int:
    """Max number of neighbour lists any single node appears in (the port
    of ``repro/privacy/pack_dp.py::node_influence_bound``, in numpy)."""
    idx = np.asarray(g.nbr_idx).reshape(-1)
    mask = np.asarray(g.nbr_mask).reshape(-1) > 0
    n = int(np.asarray(g.nbr_idx).shape[0])
    counts = np.bincount(np.where(mask, idx, n), minlength=n + 1)[:n]
    return max(int(counts.max()) if n else 0, 1)


def privacy_report(
    priv: PrivacyConfig,
    *,
    rounds: int,
    num_clients: int,
    num_selected: int,
    node_influence: Optional[int] = None,
) -> Dict[str, Any]:
    """The privacy summary of a Trainer result, with the reference's keys
    (``repro/privacy/__init__.py::privacy_report``) and its values for a
    config with every mechanism off: ``epsilon`` and its companions are
    ``None``. Raises ``NotImplementedError`` for a config that enables a
    mechanism."""
    priv.validate()
    if priv.enabled:
        raise NotImplementedError(
            "privacy mechanisms (DP, secure aggregation, pack noise) are not "
            "ported to repro_torch yet"
        )
    return {
        "enabled": False,
        "mechanism": "dp-fedavg/sgm-rdp",
        "noise_multiplier": priv.noise_multiplier,
        "clip": priv.clip,
        "secure_agg": priv.secure_agg,
        "secure_agg_mode": None,
        "trust_model": "trusted-aggregator",
        "pack_noise_multiplier": priv.pack_noise_multiplier,
        "delta": priv.delta,
        "sampling_rate": num_selected / max(num_clients, 1),
        "rounds": rounds,
        "dp_granularity": priv.dp_granularity,
        "node_influence": node_influence,
        "epsilon": None,
        "epsilon_vs_server": None,
        "pack_epsilon": None,
    }
