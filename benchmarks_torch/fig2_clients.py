"""Figure 2: test accuracy vs number of clients (iid / non-iid) for
FedGAT / DistGAT / FedGCN.

Driven through the port's ``Trainer`` on the CUDA device (``--device cpu``
for the CPU); ``--backend shard_map`` runs the identical sweep on the
shard_map backend, whose one process hosts every client, or over
``--processes`` ranks.

  PYTHONPATH=src python benchmarks_torch/fig2_clients.py [--fast] [--backend shard_map]
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

CLIENTS = (1, 5, 10, 20)
BETAS = {"non-iid": 1.0, "iid": 10_000.0}


def clients_for(fast: bool):
    return (1, 10) if fast else CLIENTS


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
    from repro_torch.federated import FederatedConfig, Trainer
    from repro_torch.graphs import make_cora_like

    clients = clients_for(fast)
    rounds = 25 if fast else 60
    g = make_cora_like(dataset, seed=seed)
    rows = []
    for method in ("fedgat", "distgat", "fedgcn"):
        for setting, beta in BETAS.items():
            for k in clients:
                cfg = FederatedConfig(
                    method=method, backend=backend, num_clients=k, beta=beta,
                    rounds=rounds, local_steps=3, seed=seed,
                    lr=0.03 if method == "fedgcn" else 0.02,
                    model=FedGATConfig(engine="direct", degree=16),
                )
                res = Trainer(cfg, device=device).run(g)
                rows.append({"dataset": dataset, "method": method,
                             "setting": setting, "clients": k,
                             "backend": backend, "acc": res["best_test"]})
    return rows


def derived(rows: List[Dict]) -> str:
    def at(m, k, s="iid"):
        v = [r["acc"] for r in rows if r["method"] == m and r["clients"] == k and r["setting"] == s]
        return v[0] if v else float("nan")

    kmax = max(r["clients"] for r in rows)
    return (f"fedgat@{kmax}cl={at('fedgat', kmax):.3f} "
            f"distgat@{kmax}cl={at('distgat', kmax):.3f} "
            f"drop_robustness={at('fedgat', kmax) - at('distgat', kmax):.3f}")


if __name__ == "__main__":
    figure_cli(run, derived, "fig2_clients", max_clients)
