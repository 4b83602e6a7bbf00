"""Large-graph scaling bench of the port: CSR build time, resident graph
bytes, and a kernel-engine layer forward at N in {1e3, 1e4, 1e5}.

The port of ``benchmarks/graph_bench.py``. Each row also records what the
dense (N, N) adjacency *would* cost, so the CSR-vs-dense memory ratio is
tracked as a first-class number. The forward is timed through both the
flat head-batched ``cheb_attn_layer`` launch and the degree-bucketed
``cheb_attn_layer_bucketed`` (one launch per bucket; its plan, with the
row indices on the device, is made once, off the clock).

``csr_mb`` counts the host graph's arrays, as the reference does;
``device_mb`` the arrays the forward reads on the device (features
float32, neighbour ids int64, mask bool). ``block_n`` records the flat
forward's node tile (``launch_plan``): the reference's
``REPRO_CHEB_BLOCK_N`` row block has no counterpart. A size's launches:
``repeats`` x (1 flat + one per bucket).

  PYTHONPATH=src python benchmarks_torch/graph_bench.py [--fast] [--device cpu]

Emits ``benchmarks_torch/results/graph_bench.json`` and
``benchmarks_torch/results/BENCH_graph.json`` (validated by
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

import numpy as np

from benchmarks_torch.common import timed, write_bench_root

# preset -> (N, forward repeats), the reference's.
_SIZES = (("sbm_1k", 1_000, 3), ("sbm_10k", 10_000, 2), ("sbm_100k", 100_000, 1))
HEADS, D_OUT = 2, 8


def sizes_for(fast: bool):
    return _SIZES[:2] if fast else _SIZES


def _graph_bytes(g) -> int:
    """Resident bytes of the graph encodings (CSR + padded neighbour lists
    + features/labels/splits)."""
    return sum(
        np.asarray(f).nbytes for f in g if hasattr(f, "nbytes")
    )


def run(fast: bool = False, device="cuda", **_) -> List[Dict]:
    import importlib

    import torch

    from repro_torch._device import resolve_device, sync
    from repro_torch.core.chebyshev import attention_series
    from repro_torch.core.fedgat_model import graph_tensors
    from repro_torch.graphs import dense_view_count, make_sbm, reset_dense_view_count
    from repro_torch.kernels.ops import (cheb_attn_layer, cheb_attn_layer_bucketed,
                                         degree_bucket_plan)

    launch_plan = importlib.import_module("repro_torch.kernels.cheb_attn").launch_plan
    dev = resolve_device(device)
    coeffs = torch.as_tensor(attention_series(4, (-4.0, 4.0)), dtype=torch.float32,
                             device=dev)

    rows = []
    reset_dense_view_count()
    for preset, n, repeats in sizes_for(fast):
        t0 = time.perf_counter()
        g = make_sbm(preset, seed=0)
        build_s = time.perf_counter() - t0
        assert g.num_nodes == n

        csr_bytes = _graph_bytes(g)
        dense_bytes = n * n  # what the purged (N, N) bool would cost

        gen = torch.Generator().manual_seed(0)
        params = {
            "W": (torch.randn((HEADS, g.feature_dim, D_OUT), generator=gen) * 0.2).to(dev),
            "a1": (torch.randn((HEADS, D_OUT), generator=gen) * 0.2).to(dev),
            "a2": (torch.randn((HEADS, D_OUT), generator=gen) * 0.2).to(dev),
        }
        h, idx, mask = graph_tensors(g, dev)
        device_bytes = sum(t.numel() * t.element_size() for t in (h, idx, mask))
        plan = [(torch.as_tensor(rows_k, device=dev), cap)
                for rows_k, cap in degree_bucket_plan(g.nbr_mask)]

        def flat():
            out = cheb_attn_layer(params, coeffs, h, idx, mask)
            sync(dev)
            return out

        def bucketed():
            out = cheb_attn_layer_bucketed(params, coeffs, h, idx, mask, plan=plan)
            sync(dev)
            return out

        with torch.no_grad():
            _, us_flat = timed(flat, repeats=repeats)
            _, us_bucketed = timed(bucketed, repeats=repeats)

        rows.append({
            "preset": preset,
            "num_nodes": n,
            "num_edges": int(g.num_undirected_edges()),
            "avg_degree": float(g.degrees().mean()),
            "padded_degree": int(g.max_degree),
            "build_s": build_s,
            "csr_mb": csr_bytes / 2**20,
            "device_mb": device_bytes / 2**20,
            "dense_adj_mb": dense_bytes / 2**20,
            "dense_over_csr": dense_bytes / max(csr_bytes, 1),
            "block_n": launch_plan(HEADS, g.max_degree, g.feature_dim, True)["tile"],
            "buckets": len(plan),
            "kernel_forward_us": us_flat,
            "bucketed_forward_us": us_bucketed,
        })
        del h, idx, mask, plan
    # the whole sweep must run CSR-only: no lazy dense view materialised
    assert dense_view_count() == 0, dense_view_count()
    write_bench_root("graph", rows)
    return rows


def derived(rows: List[Dict]) -> str:
    top = rows[-1]
    return (
        f"N={top['num_nodes']} build={top['build_s']:.2f}s "
        f"csr={top['csr_mb']:.0f}MB (dense adj would be "
        f"{top['dense_adj_mb']:.0f}MB, {top['dense_over_csr']:.0f}x)"
    )


if __name__ == "__main__":
    import argparse

    from benchmarks_torch.common import csv_row, save_results

    ap = argparse.ArgumentParser(description="large-graph scaling bench")
    ap.add_argument("--fast", action="store_true", help="skip the 1e5 size")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    t0 = time.perf_counter()
    rows = run(fast=args.fast, device=args.device)
    us = (time.perf_counter() - t0) * 1e6
    save_results("graph_bench", rows)
    print("name,us_per_call,derived")
    print(csv_row("graph_bench", us, derived(rows)), flush=True)
