"""Benchmark orchestrator of the port — one module per paper table,
figure or theorem, and the system benchmarks (kernels, graph scaling,
serving, population scale, privacy).

The port of ``benchmarks/run.py``. Prints ``name,us_per_call,derived``
CSV (us_per_call = wall time of the whole experiment; derived = the
experiment's headline numbers), and writes full row dumps to
``benchmarks_torch/results/<name>.json``.

Figure modules are DISCOVERED, not listed: every ``benchmarks_torch/*.py``
that exposes a ``run(fast=...)`` / ``derived(rows)`` pair is a benchmark
(the modules defer their heavy imports into ``run()``, so discovery stays
cheap).

  PYTHONPATH=src python -m benchmarks_torch.run [--fast] [--only NAME] [--device cpu]
"""
from __future__ import annotations

import argparse
import importlib
import pathlib
import pkgutil
import sys
import time
from typing import List, Tuple

from benchmarks_torch.common import csv_row, save_results

# Modules that are infrastructure, not benchmarks.
_NON_BENCHES = {"common", "run", "check_regression"}


def discover_benches(
    broken: List[Tuple[str, Exception]] | None = None,
) -> List[Tuple[str, object]]:
    """The one figure registry: (name, module) for every benchmark module.

    A module that fails to import is isolated, not fatal: it is appended
    to ``broken`` (when given) and skipped.
    """
    pkg_dir = str(pathlib.Path(__file__).parent)
    found = []
    for info in sorted(pkgutil.iter_modules([pkg_dir]), key=lambda m: m.name):
        if info.name in _NON_BENCHES or info.name.startswith("_"):
            continue
        try:
            mod = importlib.import_module(f"benchmarks_torch.{info.name}")
        except Exception as e:  # pragma: no cover - needs a broken module
            if broken is not None:
                broken.append((info.name, e))
            continue
        if callable(getattr(mod, "run", None)) and callable(
            getattr(mod, "derived", None)
        ):
            found.append((info.name, mod))
    return found


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true", help="reduced sweeps")
    ap.add_argument("--only", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args()

    broken: List[Tuple[str, Exception]] = []
    benches = discover_benches(broken)
    known = [name for name, _ in benches] + [name for name, _ in broken]
    if args.only and args.only not in known:
        ap.error(f"unknown benchmark {args.only!r}: discovered {known}")

    print("name,us_per_call,derived")
    failures = 0
    for name, exc in broken:  # pragma: no cover - needs a broken module
        if args.only and args.only != name:
            continue
        failures += 1
        print(csv_row(name, 0.0, f"FAILED: import: {type(exc).__name__}: {exc}"),
              flush=True)
    for name, mod in benches:
        if args.only and args.only != name:
            continue
        t0 = time.perf_counter()
        try:
            rows = mod.run(fast=args.fast, device=args.device)
            us = (time.perf_counter() - t0) * 1e6
            save_results(name, rows)
            print(csv_row(name, us, mod.derived(rows)), flush=True)
        except Exception as e:  # pragma: no cover
            failures += 1
            us = (time.perf_counter() - t0) * 1e6
            print(csv_row(name, us, f"FAILED: {type(e).__name__}: {e}"), flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
