"""Empirical privacy audit of the port: membership-inference advantage vs
epsilon.

The port of ``benchmarks/privacy_audit.py``. For each noise multiplier in
the sweep, train a federated FedGAT run and attack it with the
oracle-threshold node membership-inference harness
(``repro_torch.privacy.attacks``). Each row pairs the accountant's
(epsilon, delta) claim with the attack's realised advantage and AUC, so
the artifact is the attack-advantage-vs-epsilon curve:
the sigma=0 row (epsilon=inf) must sit strictly above the smallest-epsilon
row, and ``check_regression.py`` enforces exactly that ordering.

  PYTHONPATH=src python benchmarks_torch/privacy_audit.py [--fast] [--device cpu]

Emits ``benchmarks_torch/results/privacy_audit.json`` and
``benchmarks_torch/results/BENCH_privacy.json``.
"""
from __future__ import annotations

import math
import pathlib
import sys
import time
from typing import Dict, List

if __package__ in (None, ""):  # run as a script: wire repo root + src
    _root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_root / "src"))
    sys.path.insert(0, str(_root))

from benchmarks_torch.common import write_bench_root

# Sweep geometry, the reference's: small population at full participation,
# enough rounds for the sigma=0 model to overfit its 6-per-class training
# nodes (that gap IS the signal the attack measures); sigma is capped at 2.
_NOISE_GRID = (0.0, 0.5, 1.0, 2.0)
_FAST_GRID = (0.0, 1.0, 2.0)
_CLIP = 0.25
_CLIENTS = 4
_ROUNDS = 12
_LOCAL_STEPS = 3


def run(fast: bool = False, dataset: str = "cora_like", seed: int = 0, device="cuda",
        **_) -> List[Dict]:
    from repro_torch._device import resolve_device
    from repro_torch.core.fedgat_model import FedGATConfig
    from repro_torch.federated.trainer import FederatedConfig
    from repro_torch.graphs import make_cora_like
    from repro_torch.privacy import PrivacyConfig
    from repro_torch.privacy.attacks import run_membership_inference

    dev = resolve_device(device)
    g = make_cora_like(dataset, seed=seed)
    rows: List[Dict] = []
    for sigma in (_FAST_GRID if fast else _NOISE_GRID):
        priv = (
            PrivacyConfig()
            if sigma == 0.0
            else PrivacyConfig(noise_multiplier=sigma, clip=_CLIP)
        )
        cfg = FederatedConfig(
            method="fedgat", num_clients=_CLIENTS, rounds=_ROUNDS,
            local_steps=_LOCAL_STEPS, lr=0.03, client_fraction=1.0,
            seed=seed, model=FedGATConfig(engine="direct", degree=16),
            privacy=priv,
        )
        t0 = time.time()
        out = run_membership_inference(g, cfg, device=dev)
        eps = out["privacy"]["epsilon"]
        rows.append({
            "dataset": dataset, "mechanism": "update-dp", "attack": "mia-threshold",
            "score": out["score"], "noise_multiplier": sigma,
            "pack_noise_multiplier": 0.0,
            "clip": priv.clip, "rounds": _ROUNDS, "clients": _CLIENTS,
            "local_steps": _LOCAL_STEPS, "seed": seed,
            "epsilon": eps if eps is not None else math.inf,
            "attack_advantage": out["advantage"],
            "attack_auc": out["auc"],
            "attack_tpr": out["tpr"], "attack_fpr": out["fpr"],
            "member_mean_loss": out["member_mean"],
            "nonmember_mean_loss": out["nonmember_mean"],
            "acc": out["best_test"],
            "seconds": time.time() - t0,
        })
        print(
            f"sigma={sigma:<4} eps={rows[-1]['epsilon']:<8.3g} "
            f"advantage={out['advantage']:.3f} auc={out['auc']:.3f} "
            f"acc={out['best_test']:.3f} ({rows[-1]['seconds']:.1f}s)"
        )
    write_bench_root("privacy", rows)
    return rows


def derived(rows: List[Dict]) -> str:
    baseline = max(rows, key=lambda r: r["epsilon"])
    tightest = min(rows, key=lambda r: r["epsilon"])
    return (
        f"advantage@eps=inf={baseline['attack_advantage']:.3f} "
        f"advantage@eps={tightest['epsilon']:.3g}="
        f"{tightest['attack_advantage']:.3f}"
    )


if __name__ == "__main__":
    import argparse

    from benchmarks_torch.common import save_results

    ap = argparse.ArgumentParser(description="membership-inference privacy audit")
    ap.add_argument("--fast", action="store_true", help="reduced sigma grid")
    ap.add_argument("--dataset", default="cora_like")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    out = run(fast=args.fast, dataset=args.dataset, seed=args.seed, device=args.device)
    save_results("privacy_audit", out)
    print(derived(out))
