"""Population-scale federated rounds of the port: K clients streamed
through cohorts.

The port of ``benchmarks/fed_scale_bench.py``. The cohort scheduler
(``federated/cohort.py``) decouples the client population from the device
count, so K sweeps {8, 128, 1024} on ``tiny`` with
``max_concurrent_clients=8``, on both Trainer backends. One process drives
one device, so ``devices`` reads 1 and the ``shard_map`` backend streams
one-lane cohorts; ``vmap`` streams cohorts of 8 lanes. Each row records
rounds/s, the process peak RSS and, on the card, the peak device
allocation (``peak_device_mb``, reset per row): on the card a cohort's
lanes live in device memory, so that column carries the
O(devices)-not-O(K) round-memory claim.

  PYTHONPATH=src python benchmarks_torch/fed_scale_bench.py [--fast] [--device cpu]

Emits ``benchmarks_torch/results/fed_scale.json`` and
``benchmarks_torch/results/BENCH_fed.json`` (validated by
``check_regression.py``).
"""
from __future__ import annotations

import pathlib
import sys
import time
from typing import Dict, List

if __package__ in (None, ""):  # run as a script: wire repo root + src
    _root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_root / "src"))
    sys.path.insert(0, str(_root))

from benchmarks_torch.common import peak_rss_mb, write_bench_root

_DEVICES = 1                    # one process drives one device
_MAX_CONCURRENT = 8             # the reference's lanes a cohort
_POPULATIONS = (8, 128, 1024)
_ROUNDS = 3
_LOCAL_STEPS = 2
BACKENDS = ("vmap", "shard_map")


def run(fast: bool = False, device="cuda", **_) -> List[Dict]:
    import torch

    from repro_torch._device import resolve_device, sync
    from repro_torch.federated.trainer import FederatedConfig, run_federated
    from repro_torch.graphs import make_cora_like

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    g = make_cora_like("tiny", 0)
    populations = _POPULATIONS[:2] if fast else _POPULATIONS
    rounds = 2 if fast else _ROUNDS

    rows: List[Dict] = []
    for backend in BACKENDS:
        for K in populations:
            cfg = FederatedConfig(
                method="fedgat", num_clients=K, rounds=rounds,
                local_steps=_LOCAL_STEPS, client_fraction=1.0, seed=0,
                max_concurrent_clients=_MAX_CONCURRENT,
            )
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            result = run_federated(g, cfg, backend=backend, device=dev)
            sync(dev)
            seconds = time.perf_counter() - t0
            rows.append({
                "backend": backend,
                "num_clients": K,
                "devices": _DEVICES,
                "lanes": result["cohort"]["lanes"],
                "cohorts_per_round": result["cohort"]["cohorts_per_round"],
                "rounds": rounds,
                "rounds_per_s": rounds / seconds,
                "seconds": seconds,
                "peak_rss_mb": peak_rss_mb(),
                "peak_device_mb": (torch.cuda.max_memory_allocated(dev) / 2**20
                                   if on_card else None),
                "final_test": result["final_test"],
            })
            card = (f" peak_device={rows[-1]['peak_device_mb']:.0f}MB" if on_card else "")
            print(
                f"{backend:>9} K={K:<5} lanes={result['cohort']['lanes']} "
                f"cohorts/round={result['cohort']['cohorts_per_round']:<4} "
                f"{rows[-1]['rounds_per_s']:.3f} rounds/s "
                f"peak_rss={rows[-1]['peak_rss_mb']:.0f}MB{card}"
            )
    write_bench_root("fed", rows)
    return rows


def derived(rows: List[Dict]) -> str:
    top = max(rows, key=lambda r: r["num_clients"])
    return (
        f"K={top['num_clients']} on {top['devices']} devices "
        f"({top['backend']}): {top['rounds_per_s']:.3f} rounds/s, "
        f"peak_rss={top['peak_rss_mb']:.0f}MB"
    )


if __name__ == "__main__":
    import argparse

    from benchmarks_torch.common import save_results

    ap = argparse.ArgumentParser(description="population-scale federated bench")
    ap.add_argument("--fast", action="store_true", help="skip K=1024")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    out = run(fast=args.fast, device=args.device)
    save_results("fed_scale", out)
    print(derived(out))
