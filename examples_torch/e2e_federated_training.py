"""End-to-end driver of the port (the paper's task kind = federated graph
training), on the GPU:

1. build the dataset and Dirichlet-partition it across clients,
2. server computes + ships the one-shot FedGAT pre-training pack,
3. a few hundred FedAvg rounds of approximate GAT training,
4. evaluation curve + communication accounting + checkpointing.

The port of ``examples/e2e_federated_training.py``. The checkpoint goes to
``--ckpt`` (default ``fedgat_ckpt.npz`` in the temporary directory).

  PYTHONPATH=src python examples_torch/e2e_federated_training.py [--rounds 200] [--device cpu]
"""
import argparse
import os
import sys
import tempfile
import time

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import FedGATConfig
from repro_torch.federated import FederatedConfig, run_federated, train_centralized
from repro_torch.graphs import make_cora_like


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="end-to-end federated training")
    ap.add_argument("--dataset", default="cora_like")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--engine", default="vector")
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "fedgat_ckpt.npz"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    graph = make_cora_like(args.dataset, seed=0)
    print(f"[data] {args.dataset}: {graph.num_nodes} nodes, "
          f"{graph.num_classes} classes")

    t0 = time.time()
    cfg = FederatedConfig(
        method="fedgat", num_clients=args.clients, beta=args.beta,
        rounds=args.rounds, local_steps=3, lr=0.02,
        model=FedGATConfig(engine=args.engine, degree=args.degree),
    )
    res = run_federated(graph, cfg, device=args.device)
    print(f"[train] {args.rounds} rounds x {args.clients} clients "
          f"in {time.time() - t0:.1f}s")
    curve = res["test_curve"]
    for r in range(0, len(curve), max(len(curve) // 10, 1)):
        print(f"  round {r:4d}: test acc {curve[r]:.3f}")
    print(f"[result] best test acc {res['best_test']:.3f} "
          f"(final {res['final_test']:.3f})")
    print(f"[comm] one-shot pack: {res['comm'].download_scalars:,} scalars; "
          f"{res['comm'].cross_client_edges} cross-client edges preserved")

    central = train_centralized(graph, "gat", steps=100, device=args.device)
    print(f"[baseline] centralised GAT: {central['best_test']:.3f} "
          f"(gap {central['best_test'] - res['best_test']:+.3f})")

    save_checkpoint(args.ckpt, {"params": res["params"]}, step=args.rounds)
    print(f"[ckpt] saved aggregated model to {args.ckpt}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
