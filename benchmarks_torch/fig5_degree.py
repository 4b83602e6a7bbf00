"""Figure 5: FedGAT accuracy vs Chebyshev approximation degree (iid,
partial-iid, non-iid). The paper observes near-flat accuracy from degree 8
up, because the Chebyshev error is already small at low degree.

Driven through the port's ``Trainer`` on the CUDA device (``--device cpu``
for the CPU); ``--backend shard_map`` runs the identical sweep on the
shard_map backend, whose one process hosts every client, or over
``--processes`` ranks.

  PYTHONPATH=src python benchmarks_torch/fig5_degree.py [--fast] [--backend shard_map]
"""
from __future__ import annotations

import pathlib
import sys
from typing import Dict, List

if __package__ in (None, ""):  # run as a script: wire repo root + src
    _root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_root / "src"))
    sys.path.insert(0, str(_root))

from benchmarks_torch.common import figure_cli

DEGREES = (4, 8, 16, 32)
BETAS = {"non-iid": 1.0, "partial-iid": 100.0, "iid": 10_000.0}
NUM_CLIENTS = 10


def max_clients(fast: bool) -> int:
    return NUM_CLIENTS


def run(
    fast: bool = False,
    dataset: str = "cora_like",
    seed: int = 0,
    backend: str = "vmap",
    device=None,
) -> List[Dict]:
    from repro_torch.core import FedGATConfig
    from repro_torch.federated import FederatedConfig, Trainer
    from repro_torch.graphs import make_cora_like

    degrees = (8, 16) if fast else DEGREES
    betas = {"non-iid": 1.0, "iid": 10_000.0} if fast else BETAS
    rounds = 25 if fast else 45
    g = make_cora_like(dataset, seed=seed)
    rows = []
    for setting, beta in betas.items():
        for p in degrees:
            cfg = FederatedConfig(
                method="fedgat", backend=backend, num_clients=NUM_CLIENTS,
                beta=beta, rounds=rounds, local_steps=3, lr=0.02, seed=seed,
                model=FedGATConfig(engine="direct", degree=p),
            )
            res = Trainer(cfg, device=device).run(g)
            rows.append({"dataset": dataset, "setting": setting, "degree": p,
                         "backend": backend, "acc": res["best_test"]})
    return rows


def derived(rows: List[Dict]) -> str:
    # spread WITHIN each data-distribution setting (the paper's claim is
    # per-setting flatness across degrees >= 8)
    spreads = []
    for setting in {r["setting"] for r in rows}:
        accs = [r["acc"] for r in rows if r["setting"] == setting and r["degree"] >= 8]
        if accs:
            spreads.append(max(accs) - min(accs))
    return f"max_acc_spread_over_degrees={max(spreads):.3f} (paper: near-flat)"


if __name__ == "__main__":
    figure_cli(run, derived, "fig5_degree", max_clients)
