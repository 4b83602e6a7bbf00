"""Privacy-utility curve of the port: test accuracy vs (epsilon, delta)
for the ``repro_torch.privacy`` mechanisms, driven through the ``Trainer``.

The port of ``benchmarks/privacy_tradeoff.py``. Two sweeps share the row
schema:

  * update-dp — DP-FedAvg client updates (clip + Gaussian noise) across a
    noise_multiplier grid; epsilon composes over rounds via the RDP
    accountant (with CS(t) subsampling amplification at
    client_fraction < 1);
  * pack-dp   — calibrated one-shot noise on the pre-communicated Vector
    FedGAT pack across a pack_noise_multiplier grid (single-release
    epsilon).

``--backend shard_map`` runs the identical sweep on the shard_map backend
(``--processes N``: N ranks of a ``torch.distributed`` group).

  PYTHONPATH=src python benchmarks_torch/privacy_tradeoff.py [--fast] [--backend shard_map] [--device cpu]
"""
from __future__ import annotations

import math
import pathlib
import sys
from typing import Dict, List

if __package__ in (None, ""):  # run as a script: wire repo root + src
    _root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_root / "src"))
    sys.path.insert(0, str(_root))

from benchmarks_torch.common import figure_cli

NUM_CLIENTS = 8
CLIP = 0.5
NOISE_GRID = (0.0, 0.5, 1.0, 2.0, 4.0)
PACK_GRID = (0.0, 0.01, 0.05, 0.2)


def grids_for(fast: bool):
    if fast:
        return (0.0, 1.0, 4.0), (0.0, 0.05)
    return NOISE_GRID, PACK_GRID


def max_clients(fast: bool) -> int:
    return NUM_CLIENTS


def run(
    fast: bool = False,
    dataset: str = "cora_like",
    seed: int = 0,
    backend: str = "vmap",
    device="cuda",
) -> List[Dict]:
    from repro_torch.core import FedGATConfig
    from repro_torch.federated import FederatedConfig, PrivacyConfig, Trainer
    from repro_torch.graphs import make_cora_like

    noise_grid, pack_grid = grids_for(fast)
    rounds = 10 if fast else 40
    client_fraction = 0.5
    g = make_cora_like(dataset, seed=seed)
    rows: List[Dict] = []

    def row(mechanism: str, sigma: float, res) -> Dict:
        eps = (
            res["privacy"]["pack_epsilon"]
            if mechanism == "pack-dp"
            else res["epsilon"]
        )
        eps_srv = res["privacy"]["epsilon_vs_server"]
        return {
            "dataset": dataset, "backend": backend, "mechanism": mechanism,
            "noise_multiplier": sigma, "clip": CLIP, "rounds": rounds,
            "clients": NUM_CLIENTS, "client_fraction": client_fraction,
            "epsilon": eps if eps is not None else math.inf,
            # aggregate-level vs honest-but-curious-server figures differ
            # when secure_agg is off (see README "Privacy" caveats)
            "epsilon_vs_server": eps_srv if eps_srv is not None else math.inf,
            "trust_model": res["privacy"]["trust_model"],
            "acc": res["best_test"],
        }

    # --- update-dp: clipped + noised client deltas, epsilon over all rounds
    for sigma in noise_grid:
        cfg = FederatedConfig(
            method="fedgat", backend=backend, num_clients=NUM_CLIENTS,
            rounds=rounds, local_steps=2, lr=0.02, seed=seed,
            client_fraction=client_fraction,
            model=FedGATConfig(engine="direct", degree=16),
            privacy=PrivacyConfig(noise_multiplier=sigma, clip=CLIP),
        )
        rows.append(row("update-dp", sigma, Trainer(cfg, device=device).run(g)))

    # --- pack-dp: one-shot noise on the communicated pack ----------------
    for sigma in pack_grid:
        cfg = FederatedConfig(
            method="fedgat", backend=backend, num_clients=NUM_CLIENTS,
            rounds=rounds, local_steps=2, lr=0.02, seed=seed,
            client_fraction=client_fraction,
            model=FedGATConfig(engine="vector", degree=16),
            privacy=PrivacyConfig(pack_noise_multiplier=sigma),
        )
        rows.append(row("pack-dp", sigma, Trainer(cfg, device=device).run(g)))
    return rows


def derived(rows: List[Dict]) -> str:
    def acc_at(mech, sigma):
        v = [
            r["acc"] for r in rows
            if r["mechanism"] == mech and r["noise_multiplier"] == sigma
        ]
        return v[0] if v else float("nan")

    upd = [r for r in rows if r["mechanism"] == "update-dp"]
    noisy = [r for r in upd if math.isfinite(r["epsilon"])]
    tightest = min(noisy, key=lambda r: r["epsilon"]) if noisy else None
    parts = [f"acc@eps=inf={acc_at('update-dp', 0.0):.3f}"]
    if tightest is not None:
        parts.append(
            f"acc@eps={tightest['epsilon']:.1f}={tightest['acc']:.3f}"
        )
    pack = [r for r in rows if r["mechanism"] == "pack-dp"]
    if pack:
        worst = max(pack, key=lambda r: r["noise_multiplier"])
        parts.append(
            f"pack_acc@s={worst['noise_multiplier']}={worst['acc']:.3f}"
        )
    return " ".join(parts)


if __name__ == "__main__":
    figure_cli(run, derived, "privacy_tradeoff", max_clients)
