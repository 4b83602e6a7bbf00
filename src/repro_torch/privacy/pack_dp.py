"""Calibrated Gaussian noise on the pre-communicated FedGAT pack.

The port of ``repro/privacy/pack_dp.py``. The pack (Matrix: P/M2/K1/K2,
Vector: M1/M2/K1/K3) is released ONCE before training. Its tensors are
sums of per-neighbour terms, so each tensor's neighbour-level sensitivity
is the largest single-neighbour contribution; with the feature row-norm
bound ``Hmax = max_j ||h_j||_2`` and the projector norm
``s_U(r) = ||U_j||_F = 1/2·sqrt(2 + r² + r⁻²)``:

  Matrix pack   P : s_U(r)        M2 : Hmax · s_U(r)
                K1: sqrt(2)       K2 : sqrt(2) · Hmax
  Vector pack   M1, M2, K1 : Hmax          K3 : 1

Noise of std ``σ · sensitivity`` per tensor is the Gaussian mechanism on
the one-shot release; the accountant composes one step per noised tensor.
Vector FedGAT's ``mask4`` slot indicator stays exact. A pack can be GBs,
so :func:`noisy_pack` draws on the pack's own device, from a generator
seeded through :func:`repro_torch._rng.fold_in` (torch cannot reproduce
the reference's ``jax.random`` bits).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch._rng import fold_in, generator

# Pack fields that must stay exact: non-tensor metadata and the Vector
# pack's structural slot indicator.
_SKIP_FIELDS = ("r", "mask4")

# Both pack types release this many independently noised tensors, and ONE
# neighbour change shifts all of them: the release composes this many
# Gaussian steps in the accountant.
NUM_NOISED_TENSORS = 4


def pack_release_steps() -> int:
    """Accountant steps of one pack release: one Gaussian mechanism per
    noised tensor, composed."""
    return NUM_NOISED_TENSORS


def feature_norm_bound(h: Any) -> float:
    """Hmax = max_j ||h_j||_2 over node feature rows, in float32.

    Computed on the host as XLA computes the reference's norm: each row's
    sum of squares accumulated column by column with a fused multiply-add
    in float32 (emulated in float64, where a square is exact), so the
    bound equals the reference's on the same features.
    """
    x = (h.detach().cpu().numpy() if isinstance(h, torch.Tensor) else np.asarray(h))
    x = x.astype(np.float64)
    acc = np.zeros(x.shape[0], np.float32)
    for j in range(x.shape[1]):
        acc = (x[:, j] * x[:, j] + acc).astype(np.float32)
    return float(np.sqrt(acc).max())


def projector_norm(r: float) -> float:
    """Frobenius norm of one obfuscated projector U_j (orthonormal pair)."""
    return 0.5 * math.sqrt(2.0 + r * r + 1.0 / (r * r))


def node_influence_bound(g: Any) -> int:
    """Max number of sampled neighbour lists any single node appears in.

    Changing one node's features perturbs one per-neighbour term in every
    pack row whose neighbour list contains it, so node-level pack
    sensitivity is this bound times the edge-level one; degree-capped
    sampling bounds it by construction.
    """
    idx = np.asarray(g.nbr_idx).reshape(-1)
    mask = np.asarray(g.nbr_mask).reshape(-1) > 0
    n = int(np.asarray(g.nbr_idx).shape[0])
    counts = np.bincount(np.where(mask, idx, n), minlength=n + 1)[:n]
    return max(int(counts.max()) if n else 0, 1)


def pack_sensitivities(
    pack: Any,
    h: Any,
    *,
    granularity: str = "edge",
    node_influence: int = 1,
) -> Dict[str, float]:
    """Per-tensor sensitivity of the pack release, keyed by field name.

    ``granularity="edge"`` is the neighbour-level bound above;
    ``granularity="node"`` multiplies every bound by ``node_influence``.
    """
    if granularity not in ("edge", "node"):
        raise ValueError(f"pack granularity must be 'edge' or 'node', got {granularity!r}")
    scale = float(node_influence) if granularity == "node" else 1.0
    if scale < 1.0:
        raise ValueError(f"node_influence must be >= 1, got {node_influence}")
    hmax = feature_norm_bound(h)
    fields = set(pack._fields)
    if {"P", "M2", "K1", "K2"} <= fields:          # Matrix FedGAT pack
        s_u = projector_norm(float(pack.r))
        base = {
            "P": s_u,
            "M2": hmax * s_u,
            "K1": math.sqrt(2.0),
            "K2": math.sqrt(2.0) * hmax,
        }
    elif {"M1", "M2", "K1", "K3"} <= fields:       # Vector FedGAT pack
        base = {"M1": hmax, "M2": hmax, "K1": hmax, "K3": 1.0}
    else:
        raise ValueError(
            f"unknown pack type {type(pack).__name__!r} with fields {sorted(fields)}"
        )
    return {k: scale * v for k, v in base.items()}


@torch.no_grad()
def noisy_pack(
    key: int,
    pack: Any,
    h: Any,
    noise_multiplier: float,
    *,
    granularity: str = "edge",
    node_influence: int = 1,
) -> Any:
    """pack + N(0, (σ·sensitivity)² I) per tensor; same NamedTuple type out.

    Field ``i`` draws on its own device from a generator seeded
    ``fold_in(key, i)``. The noise buffer becomes the released tensor, so
    besides the clean pack only one field's noise is alive at a time.
    """
    if noise_multiplier < 0:
        raise ValueError(f"noise_multiplier must be >= 0, got {noise_multiplier}")
    if pack is None or noise_multiplier == 0:
        return pack
    sens = pack_sensitivities(
        pack, h, granularity=granularity, node_influence=node_influence
    )
    updates = {}
    for i, name in enumerate(pack._fields):
        if name in _SKIP_FIELDS or name not in sens:
            continue
        leaf = getattr(pack, name)
        noise = torch.randn(leaf.shape, generator=generator(fold_in(key, i), leaf.device),
                            dtype=leaf.dtype, device=leaf.device)
        updates[name] = noise.mul_(noise_multiplier * sens[name]).add_(leaf)
    return pack._replace(**updates)
