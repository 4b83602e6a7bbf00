"""Table 1: test accuracy of GCN / GAT (centralised) and DistGAT / FedGCN /
FedGAT (10 clients, iid + non-iid) on the synthetic citation stand-ins.

Federated rows are driven through the port's ``Trainer`` on the CUDA
device (``--device cpu`` for the CPU); ``--backend shard_map`` runs the
identical sweep on the shard_map backend, whose one process hosts every
client, or over ``--processes`` ranks.

  PYTHONPATH=src python benchmarks_torch/table1_accuracy.py [--fast] [--backend shard_map]
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

DATASETS = ("cora_like", "citeseer_like", "pubmed_like")
BETAS = {"non-iid": 1.0, "iid": 10_000.0}
NUM_CLIENTS = 10


def max_clients(fast: bool) -> int:
    return NUM_CLIENTS


def run(
    fast: bool = False,
    dataset: str = "all",
    seed: int = 0,
    backend: str = "vmap",
    seeds=None,
    device=None,
) -> List[Dict]:
    import numpy as np

    from repro_torch.core import FedGATConfig
    from repro_torch.federated import FederatedConfig, Trainer, train_centralized
    from repro_torch.graphs import make_cora_like

    datasets = DATASETS if dataset == "all" else (dataset,)
    if seeds is None:
        seeds = (seed, seed + 1)
    if fast:
        datasets = datasets[:1]
        seeds = seeds[:1]
    rounds = 25 if fast else 70
    rows: List[Dict] = []
    for ds in datasets:
        for name, kind in (("GCN", "gcn"), ("GAT", "gat")):
            accs = []
            for s in seeds:
                g = make_cora_like(ds, seed=s)
                accs.append(train_centralized(g, kind, steps=2 * rounds, seed=s,
                                              device=device)["best_test"])
            rows.append({"dataset": ds, "method": name, "setting": "central",
                         "backend": "central",
                         "acc": float(np.mean(accs)), "std": float(np.std(accs))})
        for method in ("distgat", "fedgcn", "fedgat"):
            for setting, beta in BETAS.items():
                accs = []
                for s in seeds:
                    g = make_cora_like(ds, seed=s)
                    cfg = FederatedConfig(
                        method=method, backend=backend, num_clients=NUM_CLIENTS,
                        beta=beta, rounds=rounds, local_steps=3, seed=s,
                        lr=0.03 if method == "fedgcn" else 0.02,
                        model=FedGATConfig(engine="direct", degree=16),
                    )
                    accs.append(Trainer(cfg, device=device).run(g)["best_test"])
                rows.append({"dataset": ds, "method": method,
                             "setting": f"10 clients, {setting}",
                             "backend": backend,
                             "acc": float(np.mean(accs)), "std": float(np.std(accs))})
    return rows


def derived(rows: List[Dict]) -> str:
    import numpy as np

    def acc(m, ds="cora_like"):
        vals = [r["acc"] for r in rows if r["method"] == m and r["dataset"] == ds]
        return float(np.mean(vals)) if vals else float("nan")

    return (f"cora GAT={acc('GAT'):.3f} fedgat={acc('fedgat'):.3f} "
            f"distgat={acc('distgat'):.3f} fedgcn={acc('fedgcn'):.3f}")


if __name__ == "__main__":
    figure_cli(run, derived, "table1_accuracy", max_clients, default_dataset="all")
