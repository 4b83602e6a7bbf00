"""Multi-pod dry-run (the port of ``repro/launch/dryrun.py``): for every
(arch x input-shape x mesh), lay the sharded step out on the production
mesh and reckon its roofline inputs, with no device and no allocation.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  python -m repro_torch.launch.dryrun ... --strategy fsdp --out build/dryrun

The reference lowers and compiles each step for 512 simulated devices and
reads XLA's analyses. The port has no compiler, so a record holds what the
placements and the model's arithmetic give: the per-device argument and
output bytes (``memory_analysis``, reckoned from each leaf's placement),
``model_flops_*``, ``model_traffic_global``, ``active_params``,
``total_params``, and a ``roofline`` from the model flops and the analytic
traffic under the H100's constants. What needs XLA's compiled program stays
out: ``lower_s``, ``compile_s``, ``hlo_bytes``, ``hlo_cost``,
``cost_analysis``, ``useful_flops_ratio`` and the roofline's
``memory_s_hlo_upper`` and collective term.
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
    active_params,
    model_flops,
    model_traffic,
    roofline_terms,
    total_params,
)
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


def run_one(arch: str, shape_name: str, multi_pod: bool, strategy: str = "megatron", *,
            mesh=None, cfg=None, shape=None) -> dict:
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
        rec["memory_analysis"] = {
            "argument_size_in_bytes": per_device_bytes(args, in_sh),
            "output_size_in_bytes": per_device_bytes(fn.out_specs, out_sh),
        }
        mt = model_traffic(cfg, shape)
        rec["model_traffic_global"] = mt
        mf = model_flops(cfg, shape, include_backward=(shape.kind == "train"))
        # per chip: the model's flops and the analytic traffic, split evenly
        rec["roofline"] = roofline_terms(mf / chips, mt / chips, 0.0, chips=1)
        del rec["roofline"]["collective_s"]
        rec["model_flops_global"] = mf
        rec["model_flops_per_chip"] = mf / chips
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
                    help="refused: the port compiles no XLA program, so it has no HLO")
    ap.add_argument("--strategy", default="megatron", choices=["megatron", "fsdp"])
    args = ap.parse_args(argv)
    if args.save_hlo is not None:
        ap.error("--save-hlo: the port compiles no XLA program, so there is no HLO to save")

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
            rec = run_one(arch, shape, args.multi_pod, args.strategy)
            path = outdir / f"{arch}__{shape}__{mesh_tag}.json"
            path.write_text(json.dumps(rec, indent=1))
            ok = rec["status"] == "ok"
            n_fail += 0 if ok else 1
            rl = rec.get("roofline", {})
            arg_gib = rec.get("memory_analysis", {}).get("argument_size_in_bytes", 0) / 2**30
            print(
                f"[{'OK' if ok else 'FAIL'}] {arch} {shape} {mesh_tag} "
                f"args/device={arg_gib:.3f}GiB bottleneck={rl.get('bottleneck', '-')}"
                + ("" if ok else f"  err={rec.get('error')}"),
                flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
