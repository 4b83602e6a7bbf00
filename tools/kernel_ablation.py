"""Where the cheb_attn forward's, poly_attn's and wkv_chunked's time goes on the
card.

    python3 tools/kernel_ablation.py [--rounds 2] [--kernels cheb_attn,poly_attn,...]

Builds copies of ``csrc/cheb_attn.cu``, ``csrc/poly_attn.cu`` and
``csrc/wkv_chunk.cu`` with one part of the work cut out (a textual
substitution in a copy under ``build/ablation/``; the sources in the
checkout are not touched), loads each copy in place of the real library and
times it as ``tools/kernel_times.py`` does (single-call medians), the real
kernel first in every round. A cut variant computes garbage: only its time
means anything. The shapes are the main paths': cheb_attn at sbm_1m's
serving shape, poly_attn at yi-6b's attention widths (bf16 and float32),
wkv_chunked at rwkv6-1.6b's widths (float32 and bf16 inputs) on its fast
path and, as "wkv_chunked general", on the general path (the CUDA-core
kernel that takes every other shape). Needs an NVIDIA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, HERE)

import torch  # noqa: E402

from chip_smoke import YI6B_ATTN, cuda_ms, nvidia_smi  # noqa: E402
from kernel_times import cheb_inputs, wkv_inputs  # noqa: E402

# The general wkv kernel's four steps per chunk (the text of csrc/wkv_chunk.cu).
WKV_GENERAL_DECAY = [("        for (int i = tid; i < hd; i += WKV_THREADS) {\n            float P",
                      "        for (int i = tid; i < 0; i += WKV_THREADS) {\n            float P")]
WKV_GENERAL_Y = [
    ("for (int idx = tid; idx < C * C; idx += WKV_THREADS) {",
     "for (int idx = tid; idx < 0; idx += WKV_THREADS) {"),
    ("for (int idx = tid; idx < C * hd; idx += WKV_THREADS) {\n"
     "            const int t = idx / hd, j",
     "for (int idx = tid; idx < 0; idx += WKV_THREADS) {\n            const int t = idx / hd, j"),
]
WKV_GENERAL_STATE = [
    ("for (int idx = tid; idx < hh; idx += WKV_THREADS) {\n            const int i = idx / hd, j",
     "for (int idx = tid; idx < 0; idx += WKV_THREADS) {\n            const int i = idx / hd, j"),
]
# The fast kernel's per-chunk calls.
WKV_FAST_DECAY = [("                decay_terms<T, HD>(st, i, h, __ldg(u + i), grp, lane);\n",
                   "")]
WKV_FAST_Y = [("            chunk_output<T, HD>(St, st, vh, vl, y + base + (int64_t)c * C * HD, "
               "j0, g, q);\n", ""),
              ("                chunk_scores<T, HD>(st, grp, lane >> 2, lane & 3);\n", "")]
WKV_FAST_STATE = [("            state_update<T, HD>(St, st, vh, vl, g, q);\n", "")]
WKV_FAST_V = [("            v_frags<T, HD>(st, j0, g, q, vh, vl);\n", "")]

# Entries whose source is not csrc/<entry>.cu.
SOURCES = {"wkv_chunked": "wkv_chunk", "wkv_chunked general": "wkv_chunk"}

# entry -> {variant: [(text in the source, its replacement), ...]}
CUTS = {
    "cheb_attn": {
        "loads only (the consumers skip every node)": [
            ("for (int nl = warp; nl < tv; nl += W) {", "for (int nl = warp; nl < 0; nl += W) {"),
        ],
        "compute only (the producer arrives without copying)": [
            ("if (bulk) {\n                if (lane == 0) {",
             "if (bulk) {\n                if (lane == 0) mbar_arrive(bar_full + 8 * s);\n"
             "                if (false) {"),
        ],
    },
    "poly_attn": {
        "no Horner (e = the clipped score)": [
            ("for (int n = P - 2; n >= 0; --n) {", "for (int n = P - 2; n >= P; --n) {"),
        ],
        "no e values (e = 0)": [("        if (dead(kt)) {", "        if (true) {")],
        "no sk": [
            ("                key_scores<T, HDP, C::BN>(sk_s + s * C::BN, "
             "kv_p + s * 2 * C::KV_BYTES, a2_s, r);", ""),
        ],
        "no e . v product": [
            ("            pv_issue<HDP, C::BN>(o[0], hi, lo, v_stage(kt));", ""),
            ("                pv_accumulate_f32<HDP, C::BN, C::MT>(\n                    o, e, "
             "kv_p + stage_of(kt) * 2 * C::KV_BYTES + C::KV_BYTES, lane, hd);", ""),
        ],
        "loads only (no e values, no sk, no product)": [
            ("        if (dead(kt)) {", "        if (true) {"),
            ("                key_scores<T, HDP, C::BN>(sk_s + s * C::BN, "
             "kv_p + s * 2 * C::KV_BYTES, a2_s, r);", ""),
            ("            pv_issue<HDP, C::BN>(o[0], hi, lo, v_stage(kt));", ""),
            ("                pv_accumulate_f32<HDP, C::BN, C::MT>(\n                    o, e, "
             "kv_p + stage_of(kt) * 2 * C::KV_BYTES + C::KV_BYTES, lane, hd);", ""),
        ],
    },
    "wkv_chunked": {
        "no decay terms": WKV_FAST_DECAY,
        "no y products": WKV_FAST_Y,
        "no state update": WKV_FAST_STATE,
        "loads only (no decay terms, no y products, no state update)":
            WKV_FAST_DECAY + WKV_FAST_Y + WKV_FAST_STATE + WKV_FAST_V,
    },
    "wkv_chunked general": {
        "no decay terms": WKV_GENERAL_DECAY,
        "no y products": WKV_GENERAL_Y,
        "no state update": WKV_GENERAL_STATE,
        "loads only (no decay terms, no y products, no state update)":
            WKV_GENERAL_DECAY + WKV_GENERAL_Y + WKV_GENERAL_STATE,
    },
}


def build_variants(kernel: str) -> dict:
    """{variant: library path}, the real kernel under "as built" and every
    cut of CUTS[kernel], all nvcc runs started together."""
    from repro_torch.kernels import _build

    out_dir = os.path.join(ROOT, "build", "ablation")
    os.makedirs(out_dir, exist_ok=True)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, out_dir)
    src = (_build.CSRC_DIR / f"{SOURCES.get(kernel, kernel)}.cu").read_text()
    texts = {"as built": src}
    for name, subs in CUTS[kernel].items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{kernel}: the cut '{name}' no longer matches the source")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        stem = kernel.replace(" ", "_")
        cu = os.path.join(out_dir, f"{stem}-{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{stem}-{i}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, cu]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{kernel} '{name}': nvcc failed\n{log[-4000:]}")
        libs[name] = lib
    return libs


def use_library(mod, path: str) -> None:
    """Make the wrapper module ``mod`` launch from the library at ``path``."""
    from repro_torch.kernels import _build

    real = _build.load_library
    _build.load_library = lambda name: ctypes.CDLL(os.path.abspath(path))
    try:
        mod._lib = None
        if hasattr(mod, "_occupancy"):
            mod._occupancy.cache_clear()
        mod._library()
    finally:
        _build.load_library = real


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--kernels", default=",".join(CUTS))
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(f"gpu: {nvidia_smi()}", flush=True)
    from repro_torch.core.chebyshev import attention_series

    gen = torch.Generator(device="cuda").manual_seed(0)
    cheb = importlib.import_module("repro_torch.kernels.cheb_attn")
    x, h_nb, mask, coeffs = cheb_inputs(gen, 8, 1_000_000, 16, 16, 17)
    poly = importlib.import_module("repro_torch.kernels.poly_attn")
    bt, heads, s, hd = YI6B_ATTN
    q, k, v = (torch.randn((bt, heads, s, hd), generator=gen, device="cuda") for _ in range(3))
    a1, a2 = (torch.randn((heads, hd), generator=gen, device="cuda") * hd**-0.5 for _ in range(2))
    att8 = torch.as_tensor(attention_series(8, (-4.0, 4.0)), dtype=torch.float32, device="cuda")
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    wkv = importlib.import_module("repro_torch.kernels.wkv_chunk")
    r, kw, vw, w, u, S0 = wkv_inputs(gen)
    rb, kwb, vwb, wb = (t.bfloat16() for t in (r, kw, vw, w))
    calls = {
        "cheb_attn": {"serve": lambda: cheb.cheb_attn(x, h_nb, mask, coeffs)},
        "poly_attn": {"bf16": lambda: poly.poly_attn(qb, kb, vb, a1, a2, att8),
                      "f32": lambda: poly.poly_attn(q, k, v, a1, a2, att8)},
        "wkv_chunked": {"f32": lambda: wkv.wkv_chunked(r, kw, vw, w, u, S0, chunk=16),
                        "bf16": lambda: wkv.wkv_chunked(rb, kwb, vwb, wb, u, S0, chunk=16)},
        "wkv_chunked general": {
            "f32": lambda: wkv._launch_general(r, kw, vw, w, u, S0, 16),
            "bf16": lambda: wkv._launch_general(rb, kwb, vwb, wb, u, S0, 16)},
    }
    mods = {"cheb_attn": cheb, "poly_attn": poly, "wkv_chunked": wkv, "wkv_chunked general": wkv}
    libs = {kernel: build_variants(kernel) for kernel in kernels}
    for rnd in range(args.rounds):
        for kernel, variants in libs.items():
            for name, path in variants.items():
                use_library(mods[kernel], path)
                times = ", ".join(f"{label} {cuda_ms(fn):.4f} ms"
                                  for label, fn in calls[kernel].items())
                print(f"round {rnd} {kernel} {name}: {times}", flush=True)


if __name__ == "__main__":
    main()
