"""``calibrate.py``'s readings for a cell of the ``federated_deep`` kind, with
two more: the fault of its own model (the reference in the program's place
without its skip, ``reference/fedgat_skip.py``'s ``"skip_dropped"``), and
the round's own conditioning (the reference in the program's place started
from the initial params each nudged 1 ulp up or down, ``ref_1ulp``).

    python3 bench/calibrate_deep.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out <file.jsonl>]

Every seed gives ``calibrate.py``'s lines (the program's reading; on a
control seed the TF32 control and the four planted faults too) and
``ref_1ulp``, and a control seed ``fault_skip_dropped`` besides. Where
``ref_1ulp`` reads as high as the program, float32 itself cannot tell the
two apart on that seed: the three Adam steps carry the last bits of the
attention vectors that the comparison leaves out into the output layer's
``W``. Runs on the card.
"""
import json
import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench.harness import spec  # noqa: E402

calibrate = spec.load_module(spec.BENCH / "calibrate.py", "bench_calibrate")


def nudged(params, seed: int):
    """``params`` with every element moved 1 ulp, up or down at random."""
    import torch

    gen = None
    out = []
    for layer in params:
        d = {}
        for k, t in layer.items():
            if gen is None:
                gen = torch.Generator(device=t.device).manual_seed(seed)
            up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
            d[k] = torch.nextafter(t, torch.where(up, torch.full_like(t, float("inf")),
                                                  torch.full_like(t, float("-inf"))))
        out.append(d)
    return out


def against_reference(cell, seed: int, control: bool) -> list:
    """``ref_1ulp`` and, with ``control``, ``fault_skip_dropped``."""
    import torch

    drv = cell.runner()
    inputs = drv.prepare(cell, seed, "cuda")
    pr = drv.reference_problem(cell, inputs, "cuda")
    ref = drv.reference_round(cell, pr, inputs)
    p0 = drv.leaves(inputs.params0)
    sides = {"ref_1ulp": lambda: drv.reference_round(
        cell, pr, replace(inputs, params0=nudged(inputs.params0, seed)))}
    if control:
        sides["fault_skip_dropped"] = lambda: drv.reference_round(
            cell, pr, inputs, fault="skip_dropped")
    lines = []
    for name, run in sides.items():
        side = run()
        lines.append({"cell": cell.name, "seed": seed, "side": name,
                      "numbers": drv.compare(cell, pr, inputs, side, ref),
                      "by_leaf": calibrate.by_leaf(side, ref, p0)})
        del side
    del pr, ref
    torch.cuda.empty_cache()
    return lines


def main(argv) -> int:
    import argparse

    import torch

    p = argparse.ArgumentParser(description="readings for a deep cell's limits")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate_deep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    for seed in seeds + sorted(control - set(seeds)):
        lines = calibrate.readings(cell, seed, seed in control)
        lines += against_reference(cell, seed, seed in control)
        for line in lines:
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
