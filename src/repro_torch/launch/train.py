"""Training launcher of the port (``repro/launch/train.py``'s two modes):

  graph  — federated FedGAT node classification (the paper's task):
           python -m repro_torch.launch.train graph --dataset cora_like \\
               --clients 10 --rounds 100 --engine vector
  lm     — language-model training of the model zoo on the synthetic
           token pipeline (``--reduced`` configs fit the CPU):
           python -m repro_torch.launch.train lm --arch yi-6b --steps 50 --reduced

Both run on the CUDA device unless given ``--device cpu``; without a card
they raise. ``lm --ckpt PATH`` writes ``{"params": ...}`` under the
reference's key paths, which either package's ``load_checkpoint`` reads.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch._device import resolve_device, sync
from repro_torch._tree import tree_leaves


def run_graph(args) -> None:
    from repro_torch.core import FedGATConfig
    from repro_torch.federated import FederatedConfig, run_federated
    from repro_torch.graphs import SBM_PRESETS, make_cora_like, make_sbm

    dev = resolve_device(args.device)
    make = make_sbm if args.dataset in SBM_PRESETS else make_cora_like
    g = make(args.dataset, seed=args.seed)
    cfg = FederatedConfig(
        method=args.method,
        num_clients=args.clients,
        beta=args.beta,
        rounds=args.rounds,
        local_steps=args.local_steps,
        lr=args.lr,
        aggregator=args.aggregator,
        seed=args.seed,
        model=FedGATConfig(engine=args.engine, degree=args.degree, basis=args.basis),
    )
    res = run_federated(g, cfg, device=dev)
    print(f"dataset={args.dataset} method={args.method} clients={args.clients} "
          f"beta={args.beta} engine={args.engine} device={dev}")
    print(f"best_val={res['best_val']:.4f} best_test={res['best_test']:.4f} "
          f"final_test={res['final_test']:.4f} seconds={res['seconds']:.1f}")
    if res["comm"]:
        print(f"pretrain_comm_scalars={res['comm'].download_scalars} "
              f"cross_client_edges={res['comm'].cross_client_edges}")


def train_lm(cfg, params, batches: Iterator[Dict[str, np.ndarray]], steps: int, *,
             log_every: int = 5, batch_tokens: int = 0) -> Dict[str, Any]:
    """``steps`` train steps (``make_train_step``) from ``params`` on their
    device over host batches. Prints ``step= loss= tok/s=`` every
    ``log_every`` steps and after the last; returns the final params and
    optimizer state, the losses and the seconds (device work included)."""
    from repro_torch.launch.steps import adam_init_f32, make_train_step

    device = tree_leaves(params)[0].device
    opt = adam_init_f32(params)
    step_fn = make_train_step(cfg)
    losses = []
    sync(device)
    t0 = time.perf_counter()
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in next(batches).items()}
        params, opt, loss = step_fn(params, opt, batch)
        losses.append(loss)
        if step % log_every == 0 or step == steps - 1:
            lv = float(loss)
            dt = time.perf_counter() - t0
            print(f"step={step} loss={lv:.4f} tok/s={(step + 1) * batch_tokens / dt:.0f}",
                  flush=True)
    sync(device)
    return {"params": params, "opt": opt, "losses": [float(x) for x in losses],
            "seconds": time.perf_counter() - t0}


def run_lm(args) -> None:
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_batches
    from repro_torch.models import build_model

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed), dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} reduced={args.reduced} params={n_params / 1e6:.2f}M device={dev}")
    extra = {}
    if cfg.family == "vlm":
        extra["prefix"] = (cfg.prefix_len, cfg.d_model)
    if cfg.is_encdec:
        extra["frames"] = (max(args.seq_len // cfg.encoder_ratio, 2), cfg.d_model)
    batches = make_lm_batches(
        cfg.vocab_size, args.batch, args.seq_len, seed=args.seed,
        prefix=extra.get("prefix"), frames=extra.get("frames"),
    )
    res = train_lm(cfg, params, batches, args.steps, log_every=args.log_every,
                   batch_tokens=args.batch * args.seq_len)
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": res["params"]}, step=args.steps)
        print(f"saved checkpoint to {args.ckpt}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)

    g = sub.add_parser("graph")
    g.add_argument("--dataset", default="cora_like",
                   help="make_cora_like or make_sbm preset")
    g.add_argument("--method", default="fedgat", choices=["fedgat", "distgat", "fedgcn"])
    g.add_argument("--clients", type=int, default=10)
    g.add_argument("--beta", type=float, default=1.0)
    g.add_argument("--rounds", type=int, default=100)
    g.add_argument("--local-steps", type=int, default=3)
    g.add_argument("--lr", type=float, default=0.01)
    g.add_argument("--aggregator", default="fedavg")
    g.add_argument("--engine", default="vector",
                   choices=["matrix", "vector", "direct", "kernel", "exact"])
    g.add_argument("--degree", type=int, default=16)
    g.add_argument("--basis", default="power", choices=["power", "chebyshev"])
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    g.set_defaults(fn=run_graph)

    lm = sub.add_parser("lm")
    lm.add_argument("--arch", required=True)
    lm.add_argument("--reduced", action="store_true")
    lm.add_argument("--steps", type=int, default=20)
    lm.add_argument("--batch", type=int, default=4)
    lm.add_argument("--seq-len", type=int, default=128)
    lm.add_argument("--log-every", type=int, default=5)
    lm.add_argument("--seed", type=int, default=0)
    lm.add_argument("--ckpt", default="")
    lm.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    lm.set_defaults(fn=run_lm)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
