"""Readings that the limits of a cell's comparison are set from.

    python3 bench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out <file.jsonl>]

For every seed of ``--seeds``: the set-up of a run (the graph, the params,
the pack, the warm call through the program's ``run_federated`` with its
local steps read), then the reference's round and the numbers compared:
the lower readings. For every seed of ``--control-seeds`` besides: the
control (the reference in the program's place, computed with TF32 on,
the precision below the configuration's float32) and the faults the check
must catch, planted in the reference in the program's place (half of each
client's labels left out, the exchange between clients left out, an
answer altered, local steps that return their state unchanged): the upper
readings. One JSON line a reading. Runs on the card; the benchmark's own
runs do not run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

FAULTS = ("half_batch", "exchange", "answer", "unchanged")


def by_leaf(prog, ref, p0) -> dict:
    """Where the numbers come from: per client and leaf, the norms behind
    ``grad1`` and ``local`` on both sides, and per leaf those behind
    ``round``, before any gap or worst leaf is taken."""
    from bench.reference import judge

    def change(leaves):
        return judge._norms([t - t0 for t, t0 in zip(leaves, p0)])

    return {
        "grad1": [[judge._norms(a), judge._norms(b)] for a, b in zip(prog.grad1, ref.grad1)],
        "local": [[change(a), change(b)] for a, b in zip(prog.local, ref.local)],
        "round": [change(prog.global_params), change(ref.global_params)],
        "losses": [[a, b] for a, b in zip(prog.losses, ref.losses)],
    }


def readings(cell, seed: int, control: bool) -> list:
    import torch

    device = "cuda"
    drv = cell.runner()
    t0 = time.perf_counter()
    inputs = drv.prepare(cell, seed, device)
    state = drv.program_state(cell, inputs, device)
    prog = drv.warm_call(state, cell)
    drv.free(state)
    pr = drv.reference_problem(cell, inputs, device)
    t1 = time.perf_counter()
    ref = drv.reference_round(cell, pr, inputs)
    t2 = time.perf_counter()
    p0 = drv.leaves(inputs.params0)
    out = [{"cell": cell.name, "seed": seed, "side": "program",
            "numbers": drv.compare(cell, pr, inputs, prog, ref),
            "program_s": t1 - t0, "reference_s": t2 - t1, "by_leaf": by_leaf(prog, ref, p0)}]
    if control:
        side = drv.reference_round(cell, pr, inputs, tf32=True)
        out.append({"cell": cell.name, "seed": seed, "side": "control_tf32",
                    "numbers": drv.compare(cell, pr, inputs, side, ref),
                    "by_leaf": by_leaf(side, ref, p0)})
        for fault in FAULTS:
            side = drv.reference_round(cell, pr, inputs, fault=fault)
            out.append({"cell": cell.name, "seed": seed, "side": f"fault_{fault}",
                        "numbers": drv.compare(cell, pr, inputs, side, ref),
                        "by_leaf": by_leaf(side, ref, p0)})
    del pr, ref, prog
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description="readings for a cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from bench.harness import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    for seed in seeds + sorted(control - set(seeds)):
        for line in readings(cell, seed, seed in control):
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
