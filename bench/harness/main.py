"""The benchmark's command line: one run of one cell, one JSON line.

``python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``

Without a CUDA device (or with fewer than the cell asks for) it exits 2
and prints no result. Otherwise the cell's traffic runner sets up, runs the
measured window and, once the window has closed and the program's state is
freed, follows the same round with the reference. The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read by ``bench/metrics/<name>.py``
from the window's spans and one profiled call.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv: List[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="bench/run.py", description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose whole top-level name is JAX's,
    its libraries' or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def checks_of(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"no reading for the limits {missing}")
    return {name: {"value": numbers[name], "limit": float(limits[name])} for name in limits}


def is_correct(checks: Dict[str, Dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    """Measure one cell on ``device`` and compose its result line (without
    printing). The per-layer readers find what they read in the runner's
    context; one that finds nothing leaves its metric out."""
    import torch

    from bench.harness import spec

    out = cell.runner().measure(cell, seed, seconds, trace, device, t_start)
    values = out["end_to_end"]
    e2e = {m["name"]: {"value": values[m["name"] if m["name"] in values
                                       else spec.base_name(m["name"])], "unit": m["unit"]}
           for m in cell.end_to_end}
    ctx = out["context"]
    layer = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            layer[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    result = {
        "correct": False,
        "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": layer if trace else e2e,
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
            "count": cell.chips,
            "memory_peak_bytes": out["memory_peak_bytes"],
        },
    }
    if trace and ctx.profile is not None:
        result["device"]["busy_s"] = ctx.profile.busy_s
        result["device"]["window_s"] = ctx.profile.window_s
        result["breakdown"] = {"device_ops": ctx.profile.device_ops(),
                               "idle_gaps": ctx.profile.gaps}
    if not trace and layer:
        # what an untraced run can read too (train_mfu, from the host clock)
        result["untraced_per_layer"] = layer
    result["card"] = power_limit() if dev.type == "cuda" else None
    numbers = out["numbers"]
    result["window"] = dict(out.get("window", {}), **{k: numbers[k] for k in numbers
                                                if k.endswith("_window")})
    checks = checks_of(numbers, cell.settings["limits"])
    result["correct"] = is_correct(checks)
    result["checks"] = checks
    return result


def main(argv: List[str], t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    from bench.harness import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False     # the configurations state float32
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
