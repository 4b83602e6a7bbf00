"""A/B of the cheb_attn backward kernel's register path against its general
path, on one NVIDIA GPU.

    python3 tools/cheb_bwd_register_ab.py

Training asks the backward for dx alone. At the sbm_1m training shape
(H8 N1e6 B16 D16, ``FedGATConfig()``'s attention series) that request takes the
register path of ``cheb_attn_bwd_kernel`` (``csrc/cheb_attn.cu``). This
script builds a second library from a copy of that source whose
``bwd_kernel`` never picks the register path, checks that both give the
same dx, and times the two in pairs through ``cheb_attn_backward``: ten
pairs, alternating which path runs first, each path timed both as the
median of 20 CUDA-event timed single calls (``chip_smoke.py``'s
``cuda_ms``) and as 20 back-to-back calls between two events. Reports the
pairs the register path won under each method. The inputs are seeded random tensors of the training
shape (80% of the mask set). Prints the card's name and power limit and
one JSON object. Needs the CUDA toolkit (``nvcc``) and a card.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.core import FedGATConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import cheb_attn as ca  # noqa: E402

# bwd_kernel's test for the register path; the general copy replaces it.
REGISTER_TEST = "if (!want_dq && !want_dh && DC >= D && B <= 32 && (B & (B - 1)) == 0) {"
PAIRS = 10


def single_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` over ``reps`` CUDA-event timed calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def back_to_back_ms(fn, reps=20, warmup=3):
    """Device time per call of ``reps`` back-to-back calls of ``fn``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def general_library(register_lib: ctypes.CDLL) -> ctypes.CDLL:
    """The backward built from a copy of csrc/cheb_attn.cu without the
    register path, with the repo library's ctypes signatures."""
    src = (_build.CSRC_DIR / "cheb_attn.cu").read_text()
    if src.count(REGISTER_TEST) != 1:
        raise RuntimeError("csrc/cheb_attn.cu: bwd_kernel's register-path test not found")
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    copy = out_dir / "cheb_attn_general.cu"
    copy.write_text(src.replace(REGISTER_TEST, "if (false) {"))
    lib_path = out_dir / "libcheb_attn_general.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(copy)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("cheb_attn_backward", "cheb_attn_bwd_blocks_per_sm", "cheb_attn_error_string"):
        getattr(lib, name).argtypes = getattr(register_lib, name).argtypes
        getattr(lib, name).restype = getattr(register_lib, name).restype
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = {"register": ca._library()}
    libs["general"] = general_library(libs["register"])

    gen = torch.Generator(device=dev).manual_seed(0)
    heads, n, b, d = 8, 1_000_000, 16, 16
    x = torch.randn(heads, n, b, generator=gen, device=dev).clamp_(-3.5, 3.5)
    mask = (torch.rand(n, b, generator=gen, device=dev) < 0.8).float()
    mask[:, 0] = 1.0
    h_nb = torch.randn(n, b, d, generator=gen, device=dev) * mask[..., None]
    dout = torch.randn(heads, n, d, generator=gen, device=dev)
    coeffs = torch.as_tensor(FedGATConfig().coeffs(), dtype=torch.float32, device=dev)
    dx_only = (True, False, False, False)

    def dx_of(name):
        ca._lib = libs[name]
        return ca.cheb_attn_backward(x, h_nb, mask, coeffs, dout, dx_only)[0]

    result = {"shape": {"H": heads, "N": n, "B": b, "D": d, "P": coeffs.numel()}}
    got, want = dx_of("register"), dx_of("general")
    result["dx_max_abs_diff"] = float((got - want).abs().max())
    result["dx_allclose"] = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
    del got, want
    ms = {name: {"single_ms": [], "back_to_back_ms": []} for name in libs}
    for pair in range(PAIRS):
        for name in (("register", "general") if pair % 2 == 0 else ("general", "register")):
            ms[name]["single_ms"].append(single_ms(lambda: dx_of(name)))
            ms[name]["back_to_back_ms"].append(back_to_back_ms(lambda: dx_of(name)))
    ca._lib = libs["register"]
    result["ms"] = ms
    result["register_wins"] = {
        method: sum(r < g for r, g in zip(ms["register"][method], ms["general"][method]))
        for method in ("single_ms", "back_to_back_ms")}
    result["median_ms"] = {name: {method: statistics.median(v) for method, v in m.items()}
                           for name, m in ms.items()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    print(json.dumps(result))
    return 0 if result["dx_allclose"] else 1


if __name__ == "__main__":
    sys.exit(main())
