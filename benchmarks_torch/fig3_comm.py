"""Figures 3-4: pre-training communication cost (scalars transferred) vs
number of clients, iid vs non-iid, Matrix FedGAT. Figure 4 extends to
20-100 clients.

Driven through the port's ``Trainer`` with ``rounds=0``: the run
performs the setup phase only (partition + pre-communication accounting,
no training rounds), so the numbers come from the same code path the
training benchmarks use, and equal the reference's. The ``direct`` engine
declares the matrix comm cost model without materialising the pack,
keeping the sweep cheap.

  PYTHONPATH=src python benchmarks_torch/fig3_comm.py [--fast] [--backend shard_map]
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
CLIENTS_FULL = (2, 5, 10, 20, 40, 60, 80, 100)
CLIENTS_FAST = (2, 5, 10, 20)


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
    from repro_torch.federated import FederatedConfig, Trainer
    from repro_torch.graphs import make_cora_like

    clients = clients_for(fast)
    g = make_cora_like(dataset, seed=seed)
    rows = []
    for setting, beta in BETAS.items():
        for k in clients:
            cfg = FederatedConfig(
                method="fedgat", backend=backend, num_clients=k, beta=beta,
                rounds=0, seed=seed,
                model=FedGATConfig(engine="direct"),
            )
            rep = Trainer(cfg, device=device).run(g)["comm"]
            rows.append({
                "dataset": dataset, "setting": setting, "clients": k,
                "backend": backend,
                "download_scalars": rep.download_scalars,
                "upload_scalars": rep.upload_scalars,
                "cross_client_edges": rep.cross_client_edges,
            })
    return rows


def derived(rows: List[Dict]) -> str:
    iid = {r["clients"]: r["download_scalars"] for r in rows if r["setting"] == "iid"}
    non = {r["clients"]: r["download_scalars"] for r in rows if r["setting"] == "non-iid"}
    ks = sorted(iid)
    growth = iid[ks[-1]] / max(iid[ks[0]], 1)
    ratio = iid[ks[-1]] / max(non[ks[-1]], 1)
    return f"growth_{ks[0]}to{ks[-1]}clients={growth:.2f}x iid/noniid={ratio:.2f}x"


if __name__ == "__main__":
    figure_cli(run, derived, "fig3_comm", max_clients)
