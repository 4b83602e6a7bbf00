"""Figures 6-8 (Appendix F): Vector FedGAT — accuracy vs clients and the
communication saving over Matrix FedGAT (O(B^2) vs O(B^3) per node).

Driven through the port's ``Trainer`` on the CUDA device (``--device cpu``
for the CPU); ``--backend shard_map`` runs the identical sweep on the
shard_map backend, whose one process hosts every client, or over
``--processes`` ranks.

  PYTHONPATH=src python benchmarks_torch/fig6_vector.py [--fast] [--backend shard_map]
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

BETAS = {"non-iid": 1.0, "iid": 10_000.0}
CLIENTS_FULL = (1, 5, 10, 20)
CLIENTS_FAST = (1, 10)


def clients_for(fast: bool):
    return CLIENTS_FAST if fast else CLIENTS_FULL


def max_clients(fast: bool) -> int:
    return max(clients_for(fast))


def run(
    fast: bool = False,
    dataset: str = "cora_like",
    seed: int = 0,
    backend: str = "vmap",
    device=None,
) -> List[Dict]:
    from repro_torch.core import FedGATConfig
    from repro_torch.federated import (
        FederatedConfig,
        Trainer,
        dirichlet_partition,
        matrix_comm_cost,
        vector_comm_cost,
    )
    from repro_torch.graphs import make_cora_like

    clients = clients_for(fast)
    rounds = 25 if fast else 45
    g = make_cora_like(dataset, seed=seed)
    rows = []
    for setting, beta in BETAS.items():
        for k in clients:
            cfg = FederatedConfig(
                method="fedgat", backend=backend, num_clients=k, beta=beta,
                rounds=rounds, local_steps=3, lr=0.02, seed=seed,
                model=FedGATConfig(engine="vector", degree=16),
            )
            res = Trainer(cfg, device=device).run(g)
            part = dirichlet_partition(g.labels, k, beta, seed)
            vec = vector_comm_cost(g, part)
            mat = matrix_comm_cost(g, part)
            rows.append({
                "dataset": dataset, "setting": setting, "clients": k,
                "backend": backend, "acc": res["best_test"],
                "vector_scalars": vec.download_scalars,
                "matrix_scalars": mat.download_scalars,
                "speedup": mat.download_scalars / max(vec.download_scalars, 1),
            })
    return rows


def derived(rows: List[Dict]) -> str:
    import numpy as np

    sp = float(np.mean([r["speedup"] for r in rows]))
    acc = float(np.mean([r["acc"] for r in rows]))
    return f"mean_comm_speedup={sp:.1f}x mean_acc={acc:.3f} (paper: ~10x)"


if __name__ == "__main__":
    figure_cli(run, derived, "fig6_vector", max_clients)
