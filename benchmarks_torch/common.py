"""Shared utilities of the port's paper-experiment drivers: timing, result
persistence, CSV emission, and the backend-aware CLI of the figure
scripts.

The port of ``benchmarks/common.py``. Rows go to
``benchmarks_torch/results/<name>.json``, and the system benchmarks' row
artifacts to ``benchmarks_torch/results/BENCH_<name>.json``
(:func:`write_bench_root`); nothing here writes the reference's repo-root
``BENCH_*.json``. Every driver runs on the CUDA device unless
``--device cpu`` (or ``device="cpu"``) asks for the CPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Any, Callable, Dict, List

RESULTS_DIR = pathlib.Path(__file__).parent / "results"

BACKEND_CHOICES = ("vmap", "shard_map")


def write_bench_root(name: str, rows: List[Dict[str, Any]]) -> pathlib.Path:
    """Write ``BENCH_<name>.json`` under :data:`RESULTS_DIR`: the per-run
    artifact of a system benchmark, which ``check_regression.py`` validates.

    With telemetry enabled, the run's Chrome trace lands next to it as
    ``BENCH_<name>_trace.json`` and every row carries a ``trace`` pointer
    to it (``check_regression`` skips ``*_trace.json``: a trace, not a
    row list)."""
    from repro_torch import telemetry

    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / f"BENCH_{name}.json"
    if telemetry.enabled():
        trace_path = RESULTS_DIR / f"BENCH_{name}_trace.json"
        telemetry.export_chrome_trace(str(trace_path))
        rows = [dict(r, trace=trace_path.name) for r in rows]
    path.write_text(json.dumps(rows, indent=1, default=str) + "\n")
    return path


def figure_cli(
    run: Callable[..., List[Dict[str, Any]]],
    derived: Callable[[List[Dict[str, Any]]], str],
    name: str,
    max_clients: Callable[[bool], int],
    argv: List[str] | None = None,
    default_dataset: str = "cora_like",
) -> None:
    """Shared ``--backend``-aware entry point for the figure scripts.

    Parses the common flags, runs, saves and prints. With ``shard_map`` in
    one process, that process hosts every client. With ``--processes N``
    the script re-executes itself as N ranks of a ``torch.distributed``
    group (``repro_torch.launch.multiprocess``); rank 0 saves and reports.
    """
    ap = argparse.ArgumentParser(description=f"benchmark {name}")
    ap.add_argument("--backend", choices=BACKEND_CHOICES, default="vmap",
                    help="federated Trainer backend (default: vmap)")
    ap.add_argument("--processes", type=int, default=1,
                    help="shard_map only: spread the clients over this many "
                    "cooperating OS processes (repro_torch.launch.multiprocess"
                    "; every swept client count must divide evenly)")
    ap.add_argument("--fast", action="store_true", help="reduced sweeps")
    ap.add_argument("--dataset", default=default_dataset)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu runs the "
                    "plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.processes > 1 and args.backend != "shard_map":
        ap.error("--processes > 1 requires --backend shard_map")
    if args.processes > 1 and max_clients(args.fast) % args.processes:
        ap.error(
            f"client count {max_clients(args.fast)} does not divide evenly "
            f"over {args.processes} processes (every process hosts an equal "
            "client block)"
        )
    from repro_torch.launch.multiprocess import (
        initialize_worker,
        launch_self,
        worker_env_active,
    )

    if args.processes > 1 and not worker_env_active():
        # Launcher side: re-exec this figure script as N workers; the
        # children land here again with the worker env set.
        base = sys.argv if argv is None else [sys.argv[0], *argv]
        per = -(-max_clients(args.fast) // args.processes)
        raise SystemExit(
            launch_self(base, processes=args.processes, devices_per_process=per)
        )
    import torch.distributed as dist

    from repro_torch import telemetry

    process_id, _, _ = initialize_worker(device=args.device)
    try:
        t0 = time.perf_counter()
        with telemetry.span("benchmark", figure=name, backend=args.backend,
                            fast=args.fast):
            rows = run(fast=args.fast, dataset=args.dataset, seed=args.seed,
                       backend=args.backend, device=args.device)
        us = (time.perf_counter() - t0) * 1e6
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if process_id != 0:
        return  # only process 0 persists and reports
    out_name = f"{name}_{args.backend}" if args.backend != "vmap" else name
    if args.processes > 1:
        out_name = f"{out_name}_p{args.processes}"
    save_results(out_name, rows)
    print("name,us_per_call,derived")
    print(csv_row(out_name, us, derived(rows)), flush=True)


def peak_rss_mb() -> float:
    """Process peak RSS in MB: ``VmHWM`` of ``/proc/self/status``, which
    starts anew at ``exec`` (``ru_maxrss`` would start a child at the peak
    of the process that launched it). Where there is no ``VmHWM`` (macOS,
    gVisor), ``ru_maxrss`` (KB, bytes on macOS): launch benches from a
    small process there."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    import resource

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if sys.platform == "darwin":
        peak //= 1024
    return peak / 1024.0


def save_results(name: str, rows: List[Dict[str, Any]]) -> None:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    (RESULTS_DIR / f"{name}.json").write_text(json.dumps(rows, indent=1, default=str))


def timed(fn: Callable, *args, repeats: int = 3, **kwargs):
    """Returns (result, best_us_per_call)."""
    best = float("inf")
    out = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return out, best


def csv_row(name: str, us: float, derived: str) -> str:
    return f"{name},{us:.1f},{derived}"
