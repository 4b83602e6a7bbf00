"""Serving benchmark of the port: the GraphInferenceServer query path under
load.

The port of ``benchmarks/serve_bench.py``. Sweeps scheduler batch size x
serving engine x client count over a fixed synthetic query stream and
reports per-cell p50/p99 latency and throughput (the microbatcher's
virtual-arrival / real-compute queue model,
``repro_torch.serving.scheduler``). The port never falls back: the
``kernel`` engine launches the CUDA ``cheb_attn`` kernel on the card (its
plain version on the CPU) or raises, so ``engine`` always equals
``engine_requested``. A server answers each client from one forward (the
``kernel`` engine: one launch) on its first query; later batches reuse it.

  PYTHONPATH=src python benchmarks_torch/serve_bench.py [--fast] [--device cpu]

Writes ``benchmarks_torch/results/BENCH_serve.json`` on every run.
"""
from __future__ import annotations

import pathlib
import sys
from typing import Dict, List

if __package__ in (None, ""):  # run as a script: wire repo root + src
    _root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_root / "src"))
    sys.path.insert(0, str(_root))

from benchmarks_torch.common import write_bench_root

ENGINES = ("direct", "kernel")


def sweep(fast: bool):
    """(batch sizes, client counts, queries a stream), the reference's."""
    if fast:
        return (8,), (2,), 64
    return (4, 16, 64), (2, 8), 512


def run(fast: bool = False, dataset: str | None = None, seed: int = 0,
        backend: str = "vmap", device="cuda") -> List[Dict]:
    import numpy as np
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core import FedGAT, FedGATConfig
    from repro_torch.graphs import make_cora_like
    from repro_torch.serving import GraphInferenceServer, MicroBatcher, Query

    dev = resolve_device(device)
    dataset = dataset or ("tiny" if fast else "cora_like")
    g = make_cora_like(dataset, seed=seed)
    model_cfg = FedGATConfig()
    params = FedGAT(model_cfg, device=dev).init(torch.Generator().manual_seed(seed), g)

    batch_sizes, client_counts, num_queries = sweep(fast)
    qps = 2000.0

    rows: List[Dict] = []
    rng = np.random.default_rng(seed)
    for clients in client_counts:
        stream = [
            Query(int(c), int(n))
            for c, n in zip(
                rng.integers(0, clients, size=num_queries),
                rng.integers(0, g.num_nodes, size=num_queries),
            )
        ]
        arrivals = list(np.cumsum(rng.exponential(1.0 / qps, size=num_queries)))
        for engine in ENGINES:
            server = GraphInferenceServer(
                params, model_cfg, g, num_clients=clients, engine=engine, device=dev,
            )
            server.serve_batch(stream[:1])  # load + build packs off-clock
            for bs in batch_sizes:
                batcher = MicroBatcher(
                    server.serve_batch, max_batch_size=bs, max_wait=0.005
                )
                batcher.run(stream, arrivals)
                s = batcher.stats.summary()
                rows.append({
                    "dataset": dataset,
                    "engine_requested": engine,
                    "engine": server.cfg.engine,
                    "clients": clients,
                    "max_batch_size": bs,
                    "queries": int(s["queries"]),
                    "batches": int(s["batches"]),
                    "mean_batch": s["mean_batch"],
                    "p50_ms": s["p50_ms"],
                    "p99_ms": s["p99_ms"],
                    "throughput_qps": s["throughput_qps"],
                    "cache_hits": server.cache.stats()["hits"],
                    "cache_misses": server.cache.stats()["misses"],
                })
    write_bench_root("serve", rows)
    return rows


def kernel_launches(rows: List[Dict]) -> int:
    """``cheb_attn`` launches of a run that gave ``rows``: one forward per
    pack miss of each ``kernel``-engine server (a server's rows carry its
    running cache counts, so its last row holds them all)."""
    last = {}
    for r in rows:
        if r["engine"] == "kernel":
            last[r["clients"]] = r["cache_misses"]
    return sum(last.values())


def derived(rows: List[Dict]) -> str:
    best = max(rows, key=lambda r: r["throughput_qps"])
    return (
        f"cells={len(rows)} best={best['throughput_qps']:.0f}qps "
        f"(engine={best['engine']} batch={best['max_batch_size']} "
        f"K={best['clients']}) p99={best['p99_ms']:.2f}ms"
    )


if __name__ == "__main__":
    import argparse
    import time

    from benchmarks_torch.common import csv_row, save_results

    ap = argparse.ArgumentParser(description="serving benchmark")
    ap.add_argument("--fast", action="store_true", help="reduced sweep")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    t0 = time.perf_counter()
    rows = run(fast=args.fast, device=args.device)
    us = (time.perf_counter() - t0) * 1e6
    save_results("serve_bench", rows)
    print("name,us_per_call,derived")
    print(csv_row("serve_bench", us, derived(rows)), flush=True)
