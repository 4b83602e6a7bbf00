"""Quickstart of the port: FedGAT in ~40 lines, on the GPU.

Builds a synthetic citation graph, runs the ONE pre-training communication
round, trains a 2-layer FedGAT across 8 federated clients with FedAvg, and
compares with the centralised GAT upper bound. The port of
``examples/quickstart.py``.

  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse
import sys

from repro_torch.core import FedGATConfig
from repro_torch.federated import FederatedConfig, run_federated, train_centralized
from repro_torch.graphs import make_cora_like


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="FedGAT quickstart")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    graph = make_cora_like("cora_like", seed=0)
    print(f"graph: {graph.num_nodes} nodes, {graph.num_undirected_edges()} edges, "
          f"{graph.num_classes} classes, max degree {graph.max_degree}")

    # --- centralised GAT (the accuracy upper bound, paper Table 1) ---
    central = train_centralized(graph, model="gat", steps=80, device=args.device)
    print(f"centralised GAT  : test acc {central['best_test']:.3f}")

    # --- FedGAT: one pre-training communication round + FedAvg rounds ---
    cfg = FederatedConfig(
        method="fedgat",
        num_clients=8,
        beta=1.0,                      # non-iid Dirichlet label split
        rounds=60,
        local_steps=3,
        lr=0.02,
        model=FedGATConfig(engine="vector", degree=16),  # Appendix-F engine
    )
    fed = run_federated(graph, cfg, device=args.device)
    print(f"FedGAT (8 clients, non-iid): test acc {fed['best_test']:.3f}")
    print(f"pre-training communication: {fed['comm'].download_scalars:,} scalars "
          f"({fed['comm'].cross_client_edges} cross-client edges kept)")
    gap = central["best_test"] - fed["best_test"]
    print(f"gap to centralised GAT: {gap:+.3f} (paper: near-zero)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
