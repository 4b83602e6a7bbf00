"""Multi-pod dry-run (the port of ``repro/launch/dryrun.py``): for every
(arch x input-shape x mesh), lay the sharded step out on the production
mesh and reckon its roofline inputs, with no device and no allocation.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  python -m repro_torch.launch.dryrun ... --strategy fsdp --out build/dryrun
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --save-hlo step.txt

The reference lowers and compiles each step for 512 simulated devices and
reads XLA's analyses of the per-device program. The port's per-device
program is one rank's eager step, which ``analysis.program.trace_step``
runs over meta tensors on a traced mesh (rank 0; every rank of a
production mesh runs the same program on blocks of the same shapes). A
record carries the reference's fields: ``memory_analysis`` (the argument
and output bytes reckoned from each leaf's placement, and the trace's peak
temporaries), ``cost_analysis`` (flops, bytes accessed and transcendentals
with each loop body once, as XLA counts them), ``hlo_bytes`` (the
listing's length; ``--save-hlo`` writes the listing), ``hlo_cost`` (the
trip-count-scaled totals, collectives by kind), the roofline from the
traced flops, the analytic traffic and the traced collective bytes under
the H100's constants (``memory_s_hlo_upper`` from the traced traffic),
``useful_flops_ratio``, the model's flops and traffic and the param
counts. Only ``lower_s`` and ``compile_s`` stay out: an eager step is
neither lowered nor compiled. ``gathered_leaves`` lists the param leaves
the step gathers over the model axis under ``launch.steps.tp_gathers``'
rule (megatron and zero1 compute with every other leaf's block).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import time
import traceback

import numpy as np

from repro_torch._tree import tree_leaves
from repro_torch.analysis.hlo import (
    H100_HBM_BW,
    active_params,
    model_flops,
    model_traffic,
    roofline_terms,
    total_params,
)
from repro_torch.analysis.program import trace_step
from repro_torch.analysis.report import DEFAULT_DIR
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh, spec_axes
from repro_torch.launch.steps import build_sharded_step


def per_device_bytes(specs, shardings) -> int:
    """Bytes one device holds of a tree placed by ``shardings`` (every
    placement splits evenly, so each device holds the same)."""
    total = 0
    for x, sh in zip(tree_leaves(specs), tree_leaves(shardings)):
        if x is None:
            continue
        split = int(np.prod([sh.mesh.shape[a] for d in spec_axes(sh.spec, x.ndim) for a in d]))
        total += x.numel() * x.element_size() // split
    return total


def run_one(arch: str, shape_name: str, multi_pod: bool, save_hlo: str | None = None,
            strategy: str = "megatron", *, mesh=None, cfg=None, shape=None) -> dict:
    """One (arch, shape, mesh) record. ``mesh``/``cfg``/``shape`` override
    the production defaults (a small mesh, a reduced config)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = INPUT_SHAPES[shape_name] if shape is None else shape
    mesh = make_production_mesh(multi_pod=multi_pod) if mesh is None else mesh
    chips = mesh.devices.size
    rec = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.devices.shape),
        "chips": chips,
        "kind": shape.kind,
        "strategy": strategy,
        "status": "ok",
    }
    t0 = time.time()
    try:
        fn, args, in_sh, out_sh = build_sharded_step(cfg, shape, mesh, strategy=strategy)
        rec["gathered_leaves"] = list(fn.gathered)
        cost, listing, temp = trace_step(fn, args, in_sh, mesh)
        rec["memory_analysis"] = {
            "argument_size_in_bytes": per_device_bytes(args, in_sh),
            "output_size_in_bytes": per_device_bytes(fn.out_specs, out_sh),
            "temp_size_in_bytes": temp,
        }
        rec["cost_analysis"] = {
            "flops": cost.flops_unscaled,
            "bytes_accessed": cost.traffic_bytes_unscaled,
            "transcendentals": cost.transcendentals_unscaled,
        }
        rec["hlo_bytes"] = len(listing)
        if save_hlo:
            pathlib.Path(save_hlo).write_text(listing)
        rec["hlo_cost"] = cost.to_dict()
        mt = model_traffic(cfg, shape)
        rec["model_traffic_global"] = mt
        # per chip: the traced program's flops and collectives, the analytic
        # traffic split evenly (the traced traffic, unfused, as the upper bound)
        rec["roofline"] = roofline_terms(cost.flops, mt / chips, cost.collective_bytes, chips=1)
        rec["roofline"]["memory_s_hlo_upper"] = cost.traffic_bytes / H100_HBM_BW
        mf = model_flops(cfg, shape, include_backward=(shape.kind == "train"))
        rec["model_flops_global"] = mf
        rec["model_flops_per_chip"] = mf / chips
        rec["useful_flops_ratio"] = (mf / chips / cost.flops) if cost.flops > 0 else None
        rec["active_params"] = active_params(cfg)
        rec["total_params"] = total_params(cfg)
    except Exception as e:  # a failed record is written, and the run goes on
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=DEFAULT_DIR)
    ap.add_argument("--save-hlo", default=None,
                    help="write the traced program's listing here (the last record's)")
    ap.add_argument("--strategy", default="megatron", choices=["megatron", "fsdp"])
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            mesh_tag = "2x16x16" if args.multi_pod else "16x16"
            if args.strategy != "megatron":
                mesh_tag += f"__{args.strategy}"
            rec = run_one(arch, shape, args.multi_pod, args.save_hlo, args.strategy)
            path = outdir / f"{arch}__{shape}__{mesh_tag}.json"
            path.write_text(json.dumps(rec, indent=1))
            ok = rec["status"] == "ok"
            n_fail += 0 if ok else 1
            rl = rec.get("roofline", {})
            arg_gib = rec.get("memory_analysis", {}).get("argument_size_in_bytes", 0) / 2**30
            flops = rec.get("hlo_cost", {}).get("flops", 0.0)
            print(
                f"[{'OK' if ok else 'FAIL'}] {arch} {shape} {mesh_tag} "
                f"trace={rec['total_s']}s args/device={arg_gib:.3f}GiB flops/device={flops:.4e} "
                f"bottleneck={rl.get('bottleneck', '-')}"
                + ("" if ok else f"  err={rec.get('error')}"),
                flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
