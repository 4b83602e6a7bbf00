"""Kernel micro-bench of the port: each CUDA kernel against its plain
PyTorch version, at the reference's shapes.

The port of ``benchmarks/kernel_bench.py``. ``us_kernel`` times the
kernel's wrapper (the CUDA kernel on the card; the plain version on the
CPU, where no kernel runs), ``us_ref_torch`` the plain version in
``repro_torch.kernels.ref``; ``max_err`` is the kernel's output against the
plain version on the same device, and ``err_over_tol`` that error over the
reference tests' tolerance (``TOLERANCES``; at most 1 means ``allclose``).

cheb_attn rows cover one head-batched launch over (H, N, B) scores against
a loop of per-head launches, and the layer through the kernel against
``core/poly_attention.py::poly_gat_layer``. The reference's TPU block
model (``select_block_sizes``, ``block_n``/``block_d``) has no counterpart:
the rows record the forward's ``launch_plan`` (``tile x d_chunk load``),
which picks the port's tiles.

Each timed call ends in a device synchronize. The first call of each
kernel (its library's load) stays off the clock. A row's kernel launches:
one warm-up call plus ``REPEATS`` timed calls (the per-head loop: H of
each).

  PYTHONPATH=src python benchmarks_torch/kernel_bench.py [--fast] [--device cpu]
"""
from __future__ import annotations

import pathlib
import sys
from typing import Dict, List

if __package__ in (None, ""):  # run as a script: wire repo root + src
    _root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_root / "src"))
    sys.path.insert(0, str(_root))

from benchmarks_torch.common import timed, write_bench_root

REPEATS = 3
# (rtol, atol): the reference tests' float32 tolerances (tests/test_kernels.py:10,136)
# and the port's cheb_attn tolerance (FMA contraction and summation order differ).
TOLERANCES = {
    "cheb_attn": (1e-4, 1e-5),
    "cheb_attn_layer": (1e-4, 1e-5),
    "cheb_attn_heads": (1e-4, 1e-5),
    "flash_attn": (2e-4, 2e-5),
    "poly_attn": (5e-4, 5e-4),
}


def cheb_shapes(fast: bool):
    """(N, B, D) of the direct rows, (N, D, B, H, D_out) of the layer row and
    the head counts of the head-batched rows."""
    if fast:
        return (128, 16, 128), (128, 48, 16, 8, 8), (4,)
    return (512, 32, 128), (320, 48, 16, 8, 8), (4, 8)


def expected_launches(fast: bool) -> Dict[str, int]:
    """Each kernel's launches in one ``run(fast)`` on the card."""
    per_call = 1 + REPEATS
    heads = cheb_shapes(fast)[2]
    return {
        "cheb_attn": per_call * (2 + sum(1 + h for h in heads)),
        "flash_attn": per_call,
        "poly_attn": per_call,
        "cheb_attn_backward": 0,
    }


def _normal(gen, shape, device, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen) * scale).to(device)


def _errors(kernel: str, got, want):
    rtol, atol = TOLERANCES[kernel]
    diff = (got - want).abs()
    return {"max_err": float(diff.max()),
            "err_over_tol": float((diff / (atol + rtol * want.abs())).max())}


def _clocked(fn, dev):
    """``fn`` followed by a wait for ``dev``, so the host clock times its work."""
    from repro_torch._device import sync

    def call():
        out = fn()
        sync(dev)
        return out
    return call


def _plan(heads: int, b: int, d: int) -> str:
    """The forward's launch plan at these widths. Tensors allocated by
    PyTorch start on 16-byte boundaries, so the plan is the aligned one."""
    import importlib

    plan = importlib.import_module("repro_torch.kernels.cheb_attn").launch_plan(
        heads, b, d, True)
    return f"{plan['tile']}x{plan['d_chunk']} {plan['load']}"


def _cheb_rows(fast: bool, dev) -> List[Dict]:
    import torch

    from repro_torch.core.chebyshev import attention_series
    from repro_torch.core.poly_attention import poly_gat_layer
    from repro_torch.kernels import cheb_attn, ref
    from repro_torch.kernels.ops import cheb_attn_layer

    rows = []
    gen = torch.Generator().manual_seed(0)
    (n, b, d), (ln, ld, lB, lH, lo), heads = cheb_shapes(fast)
    coeffs = torch.as_tensor(attention_series(16, (-4.0, 4.0)), dtype=torch.float32,
                             device=dev)
    h = _normal(gen, (n, b, d), dev)
    m = torch.ones((n, b), device=dev)

    # single head: the plain version against the kernel
    x = _normal(gen, (n, b), dev).clamp_(-3.5, 3.5)
    ref_call = _clocked(lambda: ref.cheb_attn_ref(x, h, m, coeffs), dev)
    want = ref_call()
    _, us_ref = timed(ref_call, repeats=REPEATS)
    kernel_call = _clocked(lambda: cheb_attn(x, h, m, coeffs), dev)
    out_k = kernel_call()                                          # load, off the clock
    _, us_krn = timed(kernel_call, repeats=REPEATS)
    rows.append({"kernel": "cheb_attn", "shape": f"N{n}xB{b}xD{d}p16",
                 "us_ref_torch": us_ref, "us_kernel": us_krn,
                 **_errors("cheb_attn", out_k, want)})

    # the layer through the kernel against the plain polynomial GAT layer,
    # at a ragged citation-graph width (D = 48)
    lh = _normal(gen, (ln, ld), dev)
    nbr_idx = torch.randint(0, ln, (ln, lB), generator=gen).to(dev)
    nbr_mask = torch.ones((ln, lB), dtype=torch.bool, device=dev)
    params = {"W": _normal(gen, (lH, ld, lo), dev, 0.2),
              "a1": _normal(gen, (lH, lo), dev, 0.2),
              "a2": _normal(gen, (lH, lo), dev, 0.2)}
    layer = _clocked(lambda: cheb_attn_layer(params, coeffs, lh, nbr_idx, nbr_mask), dev)
    plain_layer = _clocked(lambda: poly_gat_layer(params, coeffs, lh, nbr_idx, nbr_mask), dev)
    with torch.no_grad():
        out_layer = layer()                                        # off the clock
        want = plain_layer()
        _, us_layer = timed(layer, repeats=REPEATS)
        _, us_plain_layer = timed(plain_layer, repeats=REPEATS)
    rows.append({"kernel": "cheb_attn_layer", "shape": f"N{ln}xB{lB}xD{ld}H{lH}p16",
                 "us_ref_torch": us_plain_layer, "us_kernel": us_layer,
                 "launch_plan": _plan(lH, lB, ld),
                 **_errors("cheb_attn_layer", out_layer, want)})

    # head-batched: ONE launch for all H heads against a per-head loop
    for H in heads:
        xh = _normal(gen, (H, n, b), dev).clamp_(-3.5, 3.5)
        batched = _clocked(lambda: cheb_attn(xh, h, m, coeffs), dev)
        per_head_loop = _clocked(lambda: torch.stack([cheb_attn(xh[i], h, m, coeffs)
                                                     for i in range(H)]), dev)
        out_b = batched()                                          # off the clock
        per_head_loop()
        _, us_batched = timed(batched, repeats=REPEATS)
        _, us_loop = timed(per_head_loop, repeats=REPEATS)
        want = torch.stack([ref.cheb_attn_ref(xh[i], h, m, coeffs) for i in range(H)])
        rows.append({"kernel": "cheb_attn_heads", "shape": f"H{H}xN{n}xB{b}xD{d}p16",
                     "us_head_batched": us_batched, "us_per_head_loop": us_loop,
                     "launch_plan": _plan(H, b, d),
                     **_errors("cheb_attn_heads", out_b, want)})
    return rows


def run(fast: bool = False, device="cuda") -> List[Dict]:
    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core.chebyshev import attention_series
    from repro_torch.kernels import flash_attn, poly_attn, ref

    dev = resolve_device(device)
    rows = _cheb_rows(fast, dev)

    B, H, S, hd = (1, 2, 256, 64) if fast else (2, 4, 512, 64)
    gen = torch.Generator().manual_seed(1)
    q, k, v = (_normal(gen, (B, H, S, hd), dev) for _ in range(3))

    # flash_attn
    ref_call = _clocked(lambda: ref.flash_attn_ref(q, k, v), dev)
    want = ref_call()
    _, us_ref = timed(ref_call, repeats=REPEATS)
    kernel_call = _clocked(lambda: flash_attn(q, k, v), dev)
    out_k = kernel_call()                                          # off the clock
    _, us_krn = timed(kernel_call, repeats=REPEATS)
    rows.append({"kernel": "flash_attn", "shape": f"B{B}H{H}S{S}hd{hd}",
                 "us_ref_torch": us_ref, "us_kernel": us_krn,
                 **_errors("flash_attn", out_k, want)})

    # poly_attn
    a1 = _normal(gen, (H, hd), dev, 0.1)
    a2 = _normal(gen, (H, hd), dev, 0.1)
    pc = torch.as_tensor(attention_series(8, (-4.0, 4.0)), dtype=torch.float32, device=dev)
    ref_call = _clocked(lambda: ref.poly_attn_ref(q, k, a1, a2, v, pc), dev)
    want = ref_call()
    _, us_ref = timed(ref_call, repeats=REPEATS)
    kernel_call = _clocked(lambda: poly_attn(q, k, v, a1, a2, pc), dev)
    out_k = kernel_call()                                          # off the clock
    _, us_krn = timed(kernel_call, repeats=REPEATS)
    rows.append({"kernel": "poly_attn", "shape": f"B{B}H{H}S{S}hd{hd}p8",
                 "us_ref_torch": us_ref, "us_kernel": us_krn,
                 **_errors("poly_attn", out_k, want)})
    write_bench_root("kernel", rows)
    return rows


def derived(rows: List[Dict]) -> str:
    worst = max(r["max_err"] for r in rows)
    return f"kernels={len(rows)} worst_err={worst:.2e} (kernel vs plain version)"


if __name__ == "__main__":
    import argparse
    import time

    from benchmarks_torch.common import csv_row, save_results

    ap = argparse.ArgumentParser(description="kernel micro-bench")
    ap.add_argument("--fast", action="store_true", help="reduced shapes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    t0 = time.perf_counter()
    rows = run(fast=args.fast, device=args.device)
    us = (time.perf_counter() - t0) * 1e6
    save_results("kernel_bench", rows)
    print("name,us_per_call,derived")
    print(csv_row("kernel_bench", us, derived(rows)), flush=True)
