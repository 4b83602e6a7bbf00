"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Environment: versions, the card's name and power limit, and the build of
   every CUDA kernel under ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   each, started together).
2. Kernels against their plain PyTorch versions on the card: ``cheb_attn``
   on the inputs the serving path gives it for the ``sbm_1m`` graph (H8
   N1e6 B16 D16, p=16), with isolated rows and negative-denominator rows
   spliced in, and on ragged 2-D, 3-D and 4-D layouts. Each kernel is timed
   (median of CUDA-event timings) beside its plain version and its bound.
3. Serving: ``GraphInferenceServer`` with ``engine="kernel"`` answers 256
   Poisson queries at 2000 qps from 4 clients through ``MicroBatcher`` on
   ``sbm_1m`` with ``FedGATConfig()`` widths and seeded random weights. The
   kernels' launch counts are zeroed just before and read just after; the
   served logits are held against the ``direct`` engine, and a small graph
   served on the card against the plain path on the CPU.

The second-to-last line is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the
JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5      # FMA contraction and summation order differ
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12     # H100 SXM, float32 outside the tensor cores
SEED = 0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


def cheb_attn_bound_ms(x, h_nb, mask, coeffs, out):
    """Least time for cheb_attn on these inputs: each input read once and the
    output written once over HBM, or its float32 operations at peak."""
    nbytes = 4 * (x.numel() + h_nb.numel() + mask.numel() + coeffs.numel() + out.numel())
    p1 = coeffs.numel()
    d = h_nb.shape[-1]
    flops = x.numel() * (2 * p1 + 1 + 1 + 2 * d) + out.numel()   # Horner, mask, den, num, div
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


def row_denominator(x, mask, coeffs, i):
    """sum_b series(x[..., i, b]) * mask[..., i, b] for every head (and graph)."""
    from repro_torch.core.chebyshev import eval_power_series

    m = mask[..., i, :]
    if x.dim() == 4:
        m = m[:, None]
    return (eval_power_series(coeffs, x[..., i, :]) * m).sum(-1)


def compare_cheb_attn(label, x, h_nb, mask, coeffs, iso=(), neg=()):
    from repro_torch.kernels.cheb_attn import cheb_attn
    from repro_torch.kernels.ref import cheb_attn_ref

    got = cheb_attn(x, h_nb, mask, coeffs)
    torch.cuda.synchronize()
    want = cheb_attn_ref(x, h_nb, mask, coeffs)
    torch.cuda.synchronize()
    if got.shape != want.shape:
        fail(f"cheb_attn {label}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        fail(f"cheb_attn {label}: NaN positions differ from the plain version")
    ok = torch.isfinite(want)
    err = float((got - want).abs()[ok].max()) if bool(ok.any()) else 0.0
    close = torch.allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)
    zeros = all(bool((got[..., i, :] == 0).all()) for i in iso)
    negs = all(bool((row_denominator(x, mask, coeffs, i) < 0).all()) for i in neg)
    print(f"cheb_attn {label}: x{tuple(x.shape)} h_nb{tuple(h_nb.shape)} "
          f"max_abs_err={err:.3e} allclose(rtol={RTOL},atol={ATOL})={close} "
          f"isolated_rows_exact_zero={zeros} negative_rows={len(neg)}", flush=True)
    if not (close and zeros and negs):
        fail(f"cheb_attn {label}: kernel disagrees with its plain version")
    return err


def layer1_inputs(params, h, nbr_idx, nbr_mask):
    """What cheb_attn_layer hands the kernel (kernels/ops.py)."""
    from repro_torch.core.poly_attention import edge_scores, head_projections

    b1, b2 = head_projections(params)
    x = edge_scores(b1, b2, h, nbr_idx)
    mask_f = nbr_mask.to(h.dtype)
    return x, h[nbr_idx] * mask_f[..., None], mask_f


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    from repro_torch.core import FedGATConfig, get_engine, init_params, layered_forward
    from repro_torch.core.fedgat_model import graph_tensors
    from repro_torch.graphs import make_cora_like, make_sbm
    from repro_torch.kernels import _build
    from repro_torch.kernels.cheb_attn import cheb_attn
    from repro_torch.kernels.ref import cheb_attn_ref
    from repro_torch.serving import GraphInferenceServer, MicroBatcher, Query

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: environment and build -------------------------------------
    smi = nvidia_smi()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    print(f"gpu: {smi} (count {torch.cuda.device_count()})", flush=True)
    t0 = time.perf_counter()
    libs = _build.build(_build.kernel_names())
    print(f"kernel build: {len(libs)} libraries in {time.perf_counter() - t0:.2f}s")
    for name, info in sorted(_build.build_info.items()):
        ptxas = " | ".join(l.strip() for l in str(info["ptxas"]).splitlines() if "ptxas" in l)
        print(f"  {name}: nvcc {info['seconds']:.2f}s; {ptxas}", flush=True)

    # -- set-up: the sbm_1m graph and the model's weights ------------------
    t0 = time.perf_counter()
    g = make_sbm("sbm_1m", seed=SEED)
    cfg = FedGATConfig(engine="kernel")
    params = init_params(torch.Generator().manual_seed(SEED), g.feature_dim,
                         g.num_classes, cfg, device=dev)
    h, nbr_idx, nbr_mask = graph_tensors(g, dev)
    coeffs = torch.as_tensor(cfg.coeffs(), dtype=torch.float32, device=dev)
    print(f"sbm_1m: N={g.num_nodes} d={g.feature_dim} B={g.max_degree} "
          f"C={g.num_classes} nnz={g.nnz}; built in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- phase 2: kernels against their plain versions ----------------------
    with torch.inference_mode():
        x, h_nb, mask_f = layer1_inputs(params[0], h, nbr_idx, nbr_mask)
        errs = [compare_cheb_attn("serve", x, h_nb, mask_f, coeffs)]
        n = g.num_nodes
        iso, neg = [0, 12345, n - 1], [7, n // 2]
        x2, m2 = x.clone(), mask_f.clone()
        m2[iso] = 0.0
        x2[:, neg] = -6.0          # the degree-16 series is negative there
        m2[neg] = 1.0
        errs.append(compare_cheb_attn("serve+isolated+negative", x2, h_nb, m2, coeffs, iso, neg))
        del x2, m2
        gen = torch.Generator(device=dev).manual_seed(SEED)
        for label, lead, glead, (nn_, b, d) in [
            ("ragged-3d", (8,), (), (1001, 24, 48)),
            ("ragged-2d", (), (), (1001, 24, 48)),
            ("ragged-4d", (3, 4), (3,), (517, 8, 40)),
        ]:
            xs = torch.randn(lead + (nn_, b), generator=gen, device=dev).clamp_(-3.5, 3.5)
            ms = (torch.rand(glead + (nn_, b), generator=gen, device=dev) < 0.7).float()
            ms[..., 0] = 1.0
            ms[..., 5, :] = 0.0
            xs[..., 9, :] = -6.0
            ms[..., 9, :] = 1.0
            xs[..., 11, 3] = float("inf")       # masked infinite score -> NaN row
            ms[..., 11, 3] = 0.0
            hs = torch.randn(glead + (nn_, b, d), generator=gen, device=dev) * ms[..., None]
            errs.append(compare_cheb_attn(label, xs, hs, ms, coeffs, iso=(5,), neg=(9,)))

        out = cheb_attn(x, h_nb, mask_f, coeffs)
        ms_kernel = cuda_ms(lambda: cheb_attn(x, h_nb, mask_f, coeffs))
        ms_plain = cuda_ms(lambda: cheb_attn_ref(x, h_nb, mask_f, coeffs), reps=5, warmup=1)
        bound_ms, bound_by, nbytes = cheb_attn_bound_ms(x, h_nb, mask_f, coeffs, out)
        print(f"cheb_attn serve shape: kernel {ms_kernel:.4f} ms, plain {ms_plain:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, {nbytes / 1e9:.3f} GB), "
              f"{nbytes / (ms_kernel * 1e-3) / 1e12:.3f} TB/s achieved; no single "
              "PyTorch call computes this function, so library_ms is null", flush=True)

        # Layer-1 and whole-forward device times, for the breakdown.
        kernel_engine = get_engine("kernel")(cfg)
        direct_engine = get_engine("direct")(cfg)
        ms_layer1 = cuda_ms(lambda: kernel_engine.apply(
            params[0], None, coeffs, h, nbr_idx, nbr_mask), reps=5)
        ms_fwd = cuda_ms(lambda: layered_forward(
            kernel_engine, params, coeffs, None, h, nbr_idx, nbr_mask), reps=5)
        ms_fwd_direct = cuda_ms(lambda: layered_forward(
            direct_engine, params, coeffs, None, h, nbr_idx, nbr_mask), reps=5)
        ms_inputs = cuda_ms(lambda: layer1_inputs(params[0], h, nbr_idx, nbr_mask), reps=5)
        print(f"forward sbm_1m: layer1(kernel engine) {ms_layer1:.3f} ms, of which "
              f"scores+gather {ms_inputs:.3f} ms and kernel {ms_kernel:.3f} ms; full forward "
              f"kernel engine {ms_fwd:.3f} ms, direct engine {ms_fwd_direct:.3f} ms", flush=True)
        want_direct = layered_forward(
            direct_engine, params, coeffs, None, h, nbr_idx, nbr_mask).cpu().numpy()
        del x, h_nb, mask_f, out
    torch.cuda.empty_cache()

    # -- phase 3: serving through the kernel engine ------------------------
    server = GraphInferenceServer(params, cfg, g, method="fedgat", num_clients=4,
                                  engine="kernel", device=dev)
    rng = np.random.default_rng(SEED)
    n_q = 256
    queries = [Query(int(c), int(v)) for c, v in zip(
        rng.integers(0, server.num_clients, size=n_q), rng.integers(0, g.num_nodes, size=n_q))]
    arrivals = np.cumsum(rng.exponential(1.0 / 2000.0, size=n_q)).tolist()
    t0 = time.perf_counter()
    server._fingerprint(0)
    fp_s = time.perf_counter() - t0
    batcher = MicroBatcher(server.serve_batch, max_batch_size=32, max_wait=0.005)
    torch.cuda.reset_peak_memory_stats()
    cheb_attn.launches = 0
    t0 = time.perf_counter()
    results = batcher.run(queries, arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cheb_attn.launches
    s = batcher.stats.summary()
    cache = server.stats()["cache"]
    print(f"serve sbm_1m: {n_q} queries, {int(s['batches'])} batches (mean "
          f"{s['mean_batch']:.2f}), p50 {s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, "
          f"{s['throughput_qps']:.1f} qps, wall {wall:.3f} s, cheb_attn launches {launches}, "
          f"cache hits {cache['hits']} misses {cache['misses']} entries {cache['entries']}, "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host fingerprint of "
          f"one client's graph view {fp_s:.3f} s", flush=True)
    if launches <= 0:
        fail("the serving path launched no cheb_attn kernel")
    if len(results) != n_q or any(not np.isfinite(r.logits).all() for r in results):
        fail("served results are missing or not finite")
    mine = [r for r in results if r.client == 0]
    got = np.stack([r.logits for r in mine])
    want = want_direct[[r.node for r in mine]]
    err = float(np.abs(got - want).max())
    if got.shape[1] != g.num_classes or not np.allclose(got, want, rtol=RTOL, atol=ATOL):
        fail(f"client 0's served logits differ from the direct engine (max abs {err:.3e})")
    print(f"serve check: client 0's {len(mine)} answers match the direct engine "
          f"(max abs {err:.3e})", flush=True)

    # A small graph served on the card against the plain path on the CPU.
    tiny = make_cora_like("tiny", seed=SEED)
    tparams = init_params(torch.Generator().manual_seed(SEED), tiny.feature_dim,
                          tiny.num_classes, cfg, device="cpu")
    qs = [Query(c, v) for c in (0, 1) for v in range(tiny.num_nodes)]
    on_gpu = GraphInferenceServer(tparams, cfg, tiny, num_clients=2, engine="kernel",
                                  device=dev).serve_batch(qs)
    on_cpu = GraphInferenceServer(tparams, cfg, tiny, num_clients=2, engine="kernel",
                                  device="cpu").serve_batch(qs)
    a = np.stack([r.logits for r in on_gpu])
    b = np.stack([r.logits for r in on_cpu])
    if not np.allclose(a, b, rtol=RTOL, atol=ATOL) or [r.label for r in on_gpu] != [
            r.label for r in on_cpu]:
        fail(f"tiny: GPU and CPU serving disagree (max abs {np.abs(a - b).max():.3e})")
    print(f"tiny check: {len(qs)} answers on the card match the CPU plain path "
          f"(max abs {np.abs(a - b).max():.3e})")
    print(f"total {time.perf_counter() - t_start:.1f}s")

    print(f"gpu: {nvidia_smi()}")
    print(json.dumps({"kernels": [{
        "name": "cheb_attn",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cheb_attn.cu",
        "replaces": "src/repro/kernels/cheb_attn.py:146",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
