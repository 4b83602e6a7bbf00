"""Single-call medians of the cheb_attn forward, poly_attn and wkv_chunked on
the card, at the main paths' shapes, from seeded random inputs; each output
is held against its plain version first. Quicker than ``chip_smoke.py`` (no
graph to build, one library per kernel), for iterating on those kernels.

    python3 tools/kernel_times.py [--kernels cheb_attn,poly_attn,wkv_chunked] [--reps 20]

Shapes: cheb_attn at the sbm_1m serving shape (H8 N1e6 B16 D16, p = 17) and
at the bucketed layer's two buckets (911,115 rows at B16, 88,885 at B8);
poly_attn at yi-6b's attention widths (B2 H32 S4096 hd128, causal, the
zoo's degree-8 series on [-4, 4]), bf16 and float32; wkv_chunked at
rwkv6-1.6b's widths (BH 8x32, S4096, hd64, chunk 16), float32 and bf16
inputs, on the path ``launch_plan`` names and on the general path (the
CUDA-core kernel of every other shape) beside it. Needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    BF16_TOL, POLY_TOL, RTOL, ATOL, RWKV6_WKV, WKV_TOL, YI6B_ATTN, cheb_attn_bound_ms, cuda_ms,
    nvidia_smi, poly_bound, wkv_bound, wrapper_host_ms,
)


def cheb_inputs(gen, heads, n, b, d, p1):
    """Scores in the series' domain, masks with degrees from 1 to b, and the
    neighbour tile zero where masked, as the serving path gives them."""
    from repro_torch.core.chebyshev import attention_series

    dev = "cuda"
    x = torch.randn((heads, n, b), generator=gen, device=dev).clamp_(-3.5, 3.5)
    deg = torch.randint(1, b + 1, (n, 1), generator=gen, device=dev)
    mask = (torch.arange(b, device=dev)[None] < deg).float()
    h_nb = torch.randn((n, b, d), generator=gen, device=dev) * mask[..., None]
    coeffs = torch.as_tensor(attention_series(p1 - 1, (-4.0, 4.0)), dtype=torch.float32,
                             device=dev)
    return x, h_nb, mask, coeffs


def time_cheb(gen, reps):
    from repro_torch.kernels.ref import cheb_attn_ref

    mod = importlib.import_module("repro_torch.kernels.cheb_attn")
    for label, (n, b) in (("serve", (1_000_000, 16)), ("bucket cap 16", (911_115, 16)),
                          ("bucket cap 8", (88_885, 8))):
        x, h_nb, mask, coeffs = cheb_inputs(gen, 8, n, b, 16, 17)
        got = mod.cheb_attn(x, h_nb, mask, coeffs)
        want = cheb_attn_ref(x, h_nb, mask, coeffs)
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise SystemExit(f"cheb_attn {label}: kernel disagrees with its plain version")
        plan = mod.launch_plan(8, b, 16, mod._aligned(x, h_nb, mask))
        ms = cuda_ms(lambda: mod.cheb_attn(x, h_nb, mask, coeffs), reps=reps)
        host = wrapper_host_ms(lambda: mod.cheb_attn(x, h_nb, mask, coeffs))
        bms, by, nbytes = cheb_attn_bound_ms(x, h_nb, mask, coeffs, got)
        print(f"cheb_attn {label} x{tuple(x.shape)}: {ms:.4f} ms (single-call median of {reps}), "
              f"bound {bms:.4f} ms ({by}), {nbytes / (ms * 1e-3) / 1e12:.3f} TB/s, wrapper host "
              f"{host:.4f} ms; max abs err {float((got - want).abs().max()):.3e}; plan {plan}",
              flush=True)
        del x, h_nb, mask, got, want


def time_poly(gen, reps):
    from repro_torch.core.chebyshev import attention_series

    mod = importlib.import_module("repro_torch.kernels.poly_attn")
    bt, heads, s, hd = YI6B_ATTN
    q, k, v = (torch.randn((bt, heads, s, hd), generator=gen, device="cuda") for _ in range(3))
    a1, a2 = (torch.randn((heads, hd), generator=gen, device="cuda") * hd**-0.5 for _ in range(2))
    att8 = torch.as_tensor(attention_series(8, (-4.0, 4.0)), dtype=torch.float32, device="cuda")
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, POLY_TOL)):
        qq, kk, vv = (t.to(dtype) for t in (q, k, v))
        with torch.inference_mode():
            got = mod.poly_attn(qq, kk, vv, a1, a2, att8).float()
            want = mod.poly_attn_plain(qq, kk, vv, a1, a2, att8).float()
        if not torch.allclose(got, want, rtol=tol[0], atol=tol[1]):
            raise SystemExit(f"poly_attn {dtype}: kernel disagrees with its plain version")
        ms = cuda_ms(lambda: mod.poly_attn(qq, kk, vv, a1, a2, att8), reps=reps)
        bms, by = poly_bound(qq, att8.numel())
        print(f"poly_attn {str(dtype).replace('torch.', '')} {tuple(q.shape)}: {ms:.4f} ms "
              f"(single-call median of {reps}), bound {bms:.4f} ms ({by}); max abs err "
              f"{float((got - want).abs().max()):.3e}; plan "
              f"{mod.launch_plan(s, hd, dtype)}", flush=True)
        del got, want


def wkv_inputs(gen):
    """r, k, v, w, u, S0 at rwkv6-1.6b's widths, as ``chip_smoke.py`` phase 5
    makes them (float32)."""
    bh, s, hd = RWKV6_WKV

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    r, k, v = randn(bh, s, hd), randn(bh, s, hd), randn(bh, s, hd)
    w = torch.sigmoid(randn(bh, s, hd) + 1.0) * 0.99
    return r, k, v, w, randn(hd) * 0.1, randn(bh, hd, hd) * 0.1


def time_wkv(gen, reps):
    mod = importlib.import_module("repro_torch.kernels.wkv_chunk")
    r, k, v, w, u, S0 = wkv_inputs(gen)
    bh, s, hd = r.shape
    for dtype in (torch.float32, torch.bfloat16):
        rr, kk, vv, ww = (t.to(dtype) for t in (r, k, v, w))
        got = mod.wkv_chunked(rr, kk, vv, ww, u, S0, chunk=16)
        want = mod.wkv_chunked_plain(rr, kk, vv, ww, u, S0, chunk=16)
        err = max(float((g - x).abs().max()) for g, x in zip(got, want))
        if not all(torch.allclose(g, x, rtol=WKV_TOL[0], atol=WKV_TOL[1])
                   for g, x in zip(got, want)):
            raise SystemExit(f"wkv_chunked {dtype}: kernel disagrees with its plain version")
        plan = mod.launch_plan(hd, 16, dtype, mod._alignment(rr, kk, vv, ww))
        ms = cuda_ms(lambda: mod.wkv_chunked(rr, kk, vv, ww, u, S0, chunk=16), reps=reps)
        general = cuda_ms(lambda: mod._launch_general(rr, kk, vv, ww, u, S0, 16), reps=reps)
        host = wrapper_host_ms(lambda: mod.wkv_chunked(rr, kk, vv, ww, u, S0, chunk=16))
        bms, by = wkv_bound(rr, 16)
        print(f"wkv_chunked {str(dtype).replace('torch.', '')} (BH{bh} S{s} hd{hd} C16): "
              f"{ms:.4f} ms (single-call median of {reps}), general path {general:.4f} ms, "
              f"bound {bms:.4f} ms ({by}), wrapper host {host:.4f} ms; max abs err {err:.3e}; "
              f"plan {plan}", flush=True)
        del got, want


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default="cheb_attn,poly_attn,wkv_chunked")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(f"gpu: {nvidia_smi()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.kernels.split(","):
        {"cheb_attn": time_cheb, "poly_attn": time_poly,
         "wkv_chunked": time_wkv}[name](gen, args.reps)


if __name__ == "__main__":
    main()
