"""Which collectives gloo runs over CUDA tensors when ranks share one card.

    python3 tools/gloo_cuda_probe.py [--processes 4] [--mib 256]

Starts ``--processes`` ranks on this host through
``repro_torch.launch.multiprocess.launch`` (with one card they join with
gloo over the card's tensors). Each rank tries every collective the mesh
layer could use, on the world and on a two-rank subgroup made by
``dist.new_group``, in float32, bfloat16 and int64, checks the result
against the value it must have, and times an all_reduce and an all_gather
of ``--mib`` MiB of float32. Rank 0 prints one JSON line per collective:
``{"op", "group", "dtype", "ok", "error"}``, then the times, then the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")

WORKER = r"""
import json, sys, time
import torch
import torch.distributed as dist
from repro_torch.launch import multiprocess as mp
rank, world, collectives = mp.initialize_worker(device="cuda")
mib = float(sys.argv[1])
dev = torch.device("cuda", torch.cuda.current_device())
pair = dist.new_group([0, 1])
groups = {"world": (None, list(range(world))), "pair01": (pair, [0, 1])}
rows = []

def run(op, gname, dtype, fn):
    group, members = groups[gname]
    if rank not in members:
        return
    try:
        ok = bool(fn(group, members, dtype))
        err = None
    except Exception as e:  # a probe: record what the backend refuses
        ok, err = False, f"{type(e).__name__}: {str(e)[:200]}"
    rows.append({"op": op, "group": gname, "dtype": str(dtype), "ok": ok, "error": err,
                 "collectives": collectives})

def val(r, n, dtype):
    # small integers: exact in bfloat16, and so are their sums over 4 ranks
    return (torch.arange(n, device=dev) + 10 * r).to(dtype)

def all_reduce(group, members, dtype):
    x = val(rank, 8, dtype)
    dist.all_reduce(x, group=group)
    return torch.equal(x, sum(val(r, 8, dtype) for r in members))

def all_gather(group, members, dtype):
    out = [torch.empty(8, dtype=dtype, device=dev) for _ in members]
    dist.all_gather(out, val(rank, 8, dtype), group=group)
    return all(torch.equal(o, val(r, 8, dtype)) for o, r in zip(out, members))

def all_gather_into_tensor(group, members, dtype):
    out = torch.empty(8 * len(members), dtype=dtype, device=dev)
    dist.all_gather_into_tensor(out, val(rank, 8, dtype), group=group)
    return torch.equal(out, torch.cat([val(r, 8, dtype) for r in members]))

def reduce_scatter_tensor(group, members, dtype):
    n = len(members)
    out = torch.empty(4, dtype=dtype, device=dev)
    dist.reduce_scatter_tensor(out, val(rank, 4 * n, dtype), group=group)
    i = members.index(rank)
    return torch.equal(out, sum(val(r, 4 * n, dtype) for r in members)[4 * i:4 * i + 4])

def all_to_all_single(group, members, dtype):
    n = len(members)
    out = torch.empty(4 * n, dtype=dtype, device=dev)
    dist.all_to_all_single(out, val(rank, 4 * n, dtype), group=group)
    i = members.index(rank)
    return torch.equal(out, torch.cat([val(r, 4 * n, dtype)[4 * i:4 * i + 4] for r in members]))

def broadcast(group, members, dtype):
    x = val(rank, 8, dtype)
    dist.broadcast(x, src=members[0], group=group)
    return torch.equal(x, val(members[0], 8, dtype))

for op in (all_reduce, all_gather, all_gather_into_tensor, reduce_scatter_tensor,
           all_to_all_single, broadcast):
    for gname in ("world", "pair01"):
        for dtype in (torch.float32, torch.bfloat16, torch.int64):
            run(op.__name__, gname, dtype, op)

n = int(mib * 2**20 / 4)
x = torch.ones(n, device=dev)
outs = [torch.empty(n, device=dev) for _ in range(world)]
times = {}
for name, fn in (("all_reduce", lambda: dist.all_reduce(x)),
                 ("all_gather", lambda: dist.all_gather(outs, x))):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times[name] = (time.perf_counter() - t0) / 3
if rank == 0:
    for r in rows:
        print("PROBE " + json.dumps(r), flush=True)
    print("TIMES " + json.dumps({"mib_float32": mib, "world": world,
                                 "seconds": times}), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=4)
    ap.add_argument("--mib", type=float, default=256.0)
    args = ap.parse_args()
    sys.path.insert(0, SRC)
    import torch

    from repro_torch.launch import multiprocess as mp

    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a CUDA card")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    code = mp.launch([sys.executable, "-c", WORKER, str(args.mib)], processes=args.processes,
                     devices_per_process=1, timeout=600, env=env)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; gpu: {smi}")
    raise SystemExit(code)


if __name__ == "__main__":
    main()
