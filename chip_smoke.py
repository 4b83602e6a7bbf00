"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and no result line is printed):

1. Environment: versions, the card's name and power limit, and the build of
   every CUDA kernel under ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   each, started together), with each kernel's registers and spills and
   the tensor-core instructions (wgmma, mma.sync) in the flash, poly,
   cheb_attn and wkv libraries; poly's must hold HGMMA (bf16) and
   HMMA.1688.F32.TF32 (float32), wkv's HMMA.1688.F32.TF32.
2. Kernels against their plain PyTorch versions on the card: ``cheb_attn``
   on the inputs the serving path gives it for the ``sbm_1m`` graph (H8
   N1e6 B16 D16, p=16), with isolated rows and negative-denominator rows
   spliced in, and on ragged 2-D, 3-D and 4-D layouts. Each kernel is timed
   (median of CUDA-event timings) beside its plain version and its bound;
   the forward's ``launch_plan`` at the serving shape (which must take the
   TMA path) is printed with its wrapper's host time per call.
   The backward kernel likewise, all four cotangents against the plain
   backward and ``dx`` against ``torch.autograd`` through the plain forward,
   at the sbm_1m training shape from a real layer-1 input (with isolated and
   negative-denominator rows spliced in) and on the ragged layouts, and
   ``dx`` alone (training's request, the kernel's register path) at the
   training shape. 2c: the neighbour gathers' backward (``nbr_gather``'s
   kernel) at the local step's three gathers (layer 1's scores, H 8 F 1;
   layer 2's scores, H 1 F 1; layer 2's rows, H 1 F 40) over padded lists
   of ogbn-arxiv's size: equal bits to its plain version and to a second
   launch, within float32's reordering bound of the index backward in
   float64; its time with and without its plan beside its bound, the
   plain version and PyTorch's index backward.
3. Serving: ``GraphInferenceServer`` with ``engine="kernel"`` answers 256
   Poisson queries at 2000 qps from 4 clients through ``MicroBatcher`` on
   ``sbm_1m`` with ``FedGATConfig()`` widths and seeded random weights. The
   kernels' launch counts are zeroed just before and read just after; the
   served logits are held against the ``direct`` engine, and a small graph
   served on the card against the plain path on the CPU.
4. Training: ``run_federated`` (fedgat, ``FedGATConfig(engine="kernel")``,
   4 clients, beta 1.0, fedavg, 3 rounds of 3 local steps) on ``sbm_1m``,
   counts zeroed just before and read just after: exactly
   rounds*n_sel*local_steps backward and rounds*(n_sel*local_steps + 1)
   forward launches, 3 gather backwards a local step
   (``GATHER_BWD_PER_STEP``), finite params. Then the device times of one local
   step and its parts, and the same config on ``tiny`` on the card against
   the CPU (curves to 1e-6, params to rtol 1e-3 / atol 1e-4).
5. Kernel API: ``repro_torch.kernels``' ``flash_attn`` (causal, bf16 and
   f32) and ``poly_attn`` (the zoo's ``chebyshev`` variant: degree 8,
   domain 4, f32 and bf16, and negated coefficients for negative
   denominators) at ``yi-6b``'s attention widths (B2 H32 S4096 hd128),
   ``wkv_chunked`` at ``rwkv6-1.6b``'s (BH 8x32, S4096, hd64, chunk 16;
   float32 and bf16 inputs, on the fast path, which its ``launch_plan``
   must name), and ``ops.cheb_attn_layer_bucketed`` on ``sbm_1m`` with phase 3's
   weights. Counts zeroed just before and read just after, held exactly;
   each float32 output against its plain version (wkv also against the scan
   oracle, and its general kernel, launched outside the counted run at the
   same shape and inputs, against both) at the reference tests'
   tolerances, bf16 outputs to one bf16 ulp
   (``BF16_TOL``); ``cheb_attn`` on each bucket's inputs against its plain
   version, and the bucketed layer against the flat one; each kernel timed
   beside its plain version, its bound and, for flash,
   ``scaled_dot_product_attention``; flash's and poly's ``launch_plan``
   (tiles, load path) are printed for both dtypes, wkv's with its wrapper's
   host time, and each of the bucketed layer's cheb_attn launches is timed
   on its own inputs with its plan.
6. Pack engines (the paper's Matrix and Vector FedGAT, plain float32
   PyTorch: every kernel's count, zeroed just before each part, must read
   0 just after it, but the gathers' backward, which a training step
   launches ``GATHER_BWD_PER_STEP[engine]`` times, local steps counted as
   calls of the trainer's ``grad_of``).
   6a: ``FedGATConfig()`` (engine ``matrix``) on ``sbm_100k``: the pack
   build (its time, the part in ``torch.linalg.qr``, and its bytes against
   the reckoned 13,939,200,000), layer-1 and full-forward times for the
   matrix and direct engines (the kernel engine's are timed after the
   counts are read), matrix logits against direct (rtol 1e-3 / atol 1e-4);
   ``run_federated`` (fedgat, 4 clients, beta 1.0, fedavg, 3 rounds of 3
   local steps) with s per round, the device time of a local step and its
   profile; a 2-client server (``refresh_threshold`` 1e9) answering 128
   Poisson queries at 2000 qps, then a 64-node delta absorbed by 2
   patches, each client's eps equal to ``mass_drift`` on a CPU copy (rtol
   1e-5). The delta lifts the padded degree (``apply_delta`` re-symmetrises
   the degree-capped lists: B 16 -> 32), so a refreshed sbm_100k pack
   (54.9 GB, reckoned and printed) would not fit beside another; the
   refreshes run on ``sbm_10k`` with the same widths and delta recipe:
   the default threshold refreshing, ``refresh(0)`` bit for bit a
   from-scratch build, client 0 after it against direct on the grown
   graph, and a server at ``refresh_threshold=1e-9`` refreshing both.
   6b: engine ``vector`` on ``sbm_1m``: the pack's bytes (6,400,000,000 per
   client) and build time, 4 clients served and held against direct
   (rtol 1e-4 / atol 1e-5) before the delta and after ``refresh(0)``.
   6c: ``distgat`` through the exact engine on ``sbm_1m``, 4 clients: each
   client's answers equal ``layered_forward`` under its own edge mask.
   6d: ``tiny``: matrix training on the card from a pack built on the CPU
   against the same run on the CPU (curves to 1e-6, params rtol 1e-3 /
   atol 1e-4).

7. Cohort streaming and the privacy stack, at ``FedGATConfig()`` widths.
   Counts zeroed just before and read just after each counted run (7a-7d;
   3 gather backwards a local step).
   7a: ``sbm_100k``, fedgat through the kernel engine, K 64, beta 1.0,
   ``client_fraction`` 0.25 (16 per round), ``max_concurrent_clients`` 4
   (4 cohorts), 2 rounds of 3 local steps, fedavg: exactly 98 forward and
   96 backward ``cheb_attn`` launches; the same config through the
   Trainer's loop (``max_concurrent_clients=None``): curves to 1e-6,
   params to 1e-5 on every leaf but the output layer's ``a1`` (rounding
   noise that Adam carries from round 2 on; that leaf to rtol 1e-3 / atol
   1e-4); s per round and peak memory of both. 7b: buffered, staleness
   power 0.5, churn drop 0.2 and join 0.02: launches from ``plan_rounds``'
   live clients, the churn report equal to the plans and the counters.
   7c: DP (clip 1, sigma 0.5) with pairwise masks: a second run identical,
   epsilon equal to ``compute_epsilon``, one round with masks within 1e-5
   of one without. 7d: the protocol, buffered, drop churn 0.25, K 16:
   recovered seeds, curves equal (1e-6) and params (rtol 1e-3 / atol
   1e-4) to the mask-free run of the same churn, one round alone within
   1e-5 of its mask-free twin, the protocol's host seconds. 7e: pack noise sigma
   0.5 on a matrix pack at ``sbm_10k`` and a vector pack at ``sbm_100k``:
   each noised field's std within 1% of sigma times its sensitivity; a
   training round finite with ``pack_epsilon`` equal to the accountant's
   (matrix at sigma 0.05: at 0.5 Matrix FedGAT diverges in both packages);
   no launch but 2 gather backwards a local step. 7f: distgat (exact) at
   ``sbm_100k``, K 256, 16 per round, lanes 4, cohorts against the loop
   (curves to 1e-6), peak memory and staged mask bytes of both; no launch
   but 4 gather backwards a local step. 7g: ``tiny``, 7a's config at K 4
   (fraction 1.0, lanes 2) with DP noise on the card against the CPU
   (curves to 1e-6, params rtol 1e-3 / atol 1e-4 but the output layer's
   ``a1``), and
   ``run_membership_inference``'s advantage equal on both.

8. The distributed backends (``backend="shard_map"``), at ``FedGATConfig()``
   widths, fedgat through the kernel engine, beta 1.0. Each rank's counts
   are zeroed just before its run and read just after, in its own process
   (3 gather backwards a local step).
   8a: one process on ``sbm_100k``, K 4, fedavg, 2 rounds of 3 local steps:
   one-lane cohorts (mesh ``lanes`` [1]), exactly 26 forward and 24
   backward launches, against the same config through the loop (curves to
   1e-6, params to 1e-5 but the output layer's ``a1`` at rtol 1e-3 / atol
   1e-4). 8b: two processes on the card (``launch`` of ``RANK_WORKER``),
   phase 4's config on ``sbm_1m``: per rank 21 / 18 and 18 / 18 launches,
   equal param digests, rank 0 against phase 4's curves and params (kept
   on the host) at 8a's tolerances, the collectives the rule names (gloo
   with one card, NCCL with a card a rank). 8c: two processes on
   ``sbm_100k``, K 8, ``client_fraction`` 0.5, DP (clip 1, sigma 0.5)
   with pairwise masks, 2 rounds of 3 steps: launches per rank from
   ``selection_schedule``, equal digests, curves to 1e-6 and epsilon equal
   to the single-process loop's. Each run's s per round and wall time with
   start-up are printed.

9. The language-model substrate (``repro_torch.models``, the train and
   serve CLIs' lm paths): plain PyTorch, as the reference computes it in
   jnp, so every kernel's count, zeroed just before each part, must read 0
   just after it. 9a: ``yi-6b`` at full config (bf16, 6,061,035,520 params,
   reckoned and allocated bytes printed and held equal) through
   ``launch.serve.serve_lm``: batch 4, prompt 1024, 32 greedy tokens;
   prefill seconds, decode ms a token, tok/s, peak memory, finite logits and
   tokens inside the vocab, then one decode step's device time by
   torch.profiler (the device's idle share while decoding); the reference's
   prefill/decode property (tests/test_archs.py:59-97, rtol 5e-3 / atol
   5e-4) in float32 at full width with 4 layers. 9b: ``rwkv6-1.6b`` likewise
   (bf16, batch 4, prompt 512, gen 32; the property with 2 layers). 9c:
   ``granite-moe-1b-a400m`` at full config through ``launch.train.train_lm``:
   20 steps of batch 4 x 1024: s a step, tok/s, peak memory,
   ``moe_drop_frac``, every loss finite, the first within 1.5 of
   log(49408), the mean of the last 5 below the first, every param float32
   after the first step; then one step's device time. 9d: every assigned
   arch's ``reduced()`` config, params drawn once on the CPU and copied to
   the card: forward, prefill logits and cache, one decode step and the loss
   at rtol 1e-4 / atol 1e-5, the grads at rtol 1e-3 / atol 1e-5, and one
   train step (params at rtol 1e-4 / atol 1e-5 where |g| >= 1e-6, else
   within 2 lr).

10. The mesh layer (``repro_torch.launch.{mesh,pspec,sharding,specs,
   steps,dryrun}``, ``moe_ffn_sharded``): plain PyTorch and collectives, so
   every kernel's count, zeroed just before each part (in each rank's
   process, just before each sharded step), must read 0 just after it.
   10a: ``launch.dryrun.run_one`` (each record's per-device program
   traced over meta tensors by ``analysis.program.trace_step``, on the
   host, in ``DRYRUN_WORKERS`` worker processes started after phase 5 that
   run beside phases 6-9, each worker's own counts zeroed just before each
   record and read just after) for the ten archs at
   ``train_4k`` and ``decode_32k`` and rwkv6-1.6b and hymba-1.5b at
   ``prefill_32k`` on 16x16 megatron, and yi-6b ``train_4k`` on 2x16x16
   and under 16x16 fsdp, every record ``ok``; each record's flops, bytes
   all-gathered and the param leaves gathered under the tensor-parallel
   rule (``launch.steps.tp_gathers``), traffic, collectives,
   transcendentals, temp bytes and bottleneck; the
   roofline table of the 16x16 megatron records with T_collective;
   dbrx-132b ``train_4k``'s per-device argument bytes under megatron, zero1
   and fsdp. The same workers trace 10c's program on each of the four
   ranks, for each of its steps. 10b: a (2, 2) mesh of four ranks
   sharing the card (``launch`` of ``MESH_WORKER``; gloo over the card's
   tensors; megatron and zero1 tensor parallel over ``model``):
   ``granite-moe-1b-a400m`` at full width, float32, 4 layers,
   capacity factor E, batch 4 x 128 from the Zipf stream; one train step
   each under megatron, zero1, fsdp and megatron with 2 microbatches, one
   prefill and one decode step (megatron), held against the single-device
   steps on the same card and inputs (the train step with as many
   microbatches as the sharded step routes the MoE in: data shards times
   microbatches under megatron and zero1): loss at rtol 1e-5, the gathered
   params at rtol 1e-5 where |g| >= 1e-6 and within 2 lr elsewhere (PR
   20's rule), logits and caches at rtol 1e-4 / atol 1e-5; each step's
   seconds and collective bytes per rank. The same on a (1, 2) mesh at the
   config's capacity factor (1.25; tokens drop, alike). 10c: the full
   config (bf16, 24 layers) on the (2, 2) mesh, megatron, batch 4 x 1024
   (cut only if the four ranks' reckoned bytes exceed ``RANKS_GIB``; the
   reckoning from the rank's blocks is printed first): 2 steps, each
   rank's seconds, peak GiB (``max_memory_allocated``, beside the
   reckoning) and bytes by collective per step, equal to the rank's traced
   program's
   (calls and bytes by kind); finite losses, the first within 1.5 of
   log(49408), params float32 after the first step.

11. The reference API and the paper's experiment drivers: plain PyTorch
   and the Trainer's ``direct``, ``exact`` and ``vector`` engines and GCN,
   so every kernel's count, zeroed just before each part, must read 0 just
   after it, but the gathers' backward, one launch a gradient node the
   gathers built (``NbrGather.apply`` calls, counted).
   ``reset_dense_view_count()`` runs before phase 3, and
   ``dense_view_count()`` after phase 10 must read 0: every graph path up
   to ``sbm_1m`` stays on the CSR and neighbour lists. 11a: ``make_sbm(
   "sbm_100k").adj`` raises ``DenseAdjacencyError``; on ``cora_like`` at
   ``FedGATConfig()`` widths the dense ``gat_forward`` against its
   neighbour-list form (rtol 1e-5 / atol 1e-5, tests/test_gat.py:33), the
   dense ``gcn_forward`` on ``normalized_adjacency`` against
   ``gcn_forward_nbr`` (atol 1e-5, tests/test_bucketed_kernel.py:108),
   ``moments_direct`` on the card against a CPU copy (rtol 1e-5 / atol
   1e-6). 11b: each paper driver that ``benchmarks_torch.run``'s discovery
   finds (its 14 modules less phase 12's six system benchmarks) runs its
   ``fast`` sweep on the card (``run(fast=True, device=...)``), the eight
   side by side in ``POOL_WORKERS`` worker processes (host-bound loops;
   each worker's counts zeroed just before its driver and read just
   after): its rows, local steps (calls of the trainer's ``grad_of``),
   seconds and ``derived`` line; thm2's and fig3's rows equal to the CPU's, thm35's
   and stability's within rtol 1e-4 / atol 1e-6 of the CPU's (``err_power``
   rtol 1e-3 where finite, flags equal), every accuracy finite and in
   [0, 1].

12. The system benchmarks, the two smokes and the four examples, each
   through its own entry point on the card, each in a process of its own
   (started while the module before runs, released by "go"), the counts
   zeroed in that process just before the call and read just after, held
   exactly as reckoned from the code (and the gathers' backward at one
   launch a gradient node the gathers built, counted there): ``benchmarks_torch`` ``kernel_bench``
   (one warm-up and ``REPEATS`` timed calls a kernel a row: 28 cheb_attn,
   4 flash_attn, 4 poly_attn at ``--fast``; each row within phase 5's
   tolerance), ``graph_bench`` (repeats x (1 flat + one a bucket) at
   sbm_1k and sbm_10k; no dense view), ``serve_bench`` (one forward a
   client of the ``kernel`` server; ``engine`` equal to the one asked
   for), ``fed_scale_bench``, ``privacy_audit`` and ``privacy_tradeoff``
   (vmap) at ``--fast`` (no kernel but the gathers' backward; accuracies
   in [0, 1]),
   ``large_graph_smoke`` (one flat layer on sbm_100k; no dense view, RSS
   under its budget), ``telemetry_smoke`` at its 5% gate (no kernel but
   the gathers' backward);
   ``examples_torch`` ``quickstart``, ``e2e_federated_training`` (20
   rounds), ``engines_and_privacy`` (one forward through the kernel engine;
   every engine against ``direct`` at the serving tolerances, a masked
   round within 1e-5 of the plain one) and ``lm_train_smoke``
   (granite-moe-1b-a400m reduced). No module loads ``jax``, ``repro`` or
   ``benchmarks``. Each module's seconds and derived line are printed.

The second-to-last line is a JSON object describing each kernel
(``launches``: cheb_attn's over the serving, training, kernel-API, cohort,
distributed, bench and example phases, split in ``launches_by_path``, the
backward's and the gathers' backward's over the training, cohort,
distributed, bench and example phases, the sequence kernels' over the
kernel-API phase and the benches; ``max_abs_err``: kernel against plain
version; the gathers' backward's times at each of phase 2c's shapes under
``by_shape``); the last line is ``{"ok": true,
"device": {...}}``. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from collections import Counter

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5      # FMA contraction and summation order differ
# Gradients: the derivative of a degree-16 monomial series cancels
# differently under another summation order; the reference's own gradient
# tolerance (tests/test_kernel_engine.py:275-276).
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
# The LM grads card against CPU: the port's LM tests' gradient rtol
# (tests/test_torch_lm_models.py) at the card-vs-CPU atol.
LM_GRAD_RTOL = 1e-3
F32_ULP = 2.0 ** -24         # unit roundoff of float32
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12     # H100 SXM, float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # H100 SXM, bf16 on the tensor cores, dense
TF32_FLOPS_PER_S = 495e12    # H100 SXM, TF32 on the tensor cores, dense
# The reference tests' float32 tolerances for the sequence kernels (tests/test_kernels.py).
FLASH_TOL = (2e-4, 2e-5)     # :10
POLY_TOL = (5e-4, 5e-4)      # :136
WKV_TOL = (1e-4, 1e-4)       # :208-209
# bfloat16 outputs (flash and poly): kernel and plain version both round a
# float32 result, so they differ by at most one bf16 ulp, 2^-7 |want| < 1e-2
# |want|. The reference's bf16 tolerance (2e-2/2e-2, :10) is set for S <= 128;
# at S = 4096 a typical causal |out| is ~0.04 and that atol would pass most
# rows whatever they held.
BF16_TOL = (1e-2, 1e-3)
SEED = 0
YI6B_ATTN = (2, 32, 4096, 128)     # B, H, S, hd: configs/yi_6b.py, d_model 4096 / 32 heads
RWKV6_WKV = (8 * 32, 4096, 64)     # B*H, S, head size: configs/rwkv6_1_6b.py, 2048 / 64 heads


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """'kernel: R registers, S bytes spill stores' for each entry function
    in an ``nvcc -Xptxas -v`` log."""
    rows, fn, spill = [], None, "0"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = line.split("bytes spill stores")[0].split(",")[-1].strip()
        elif "Used" in line and "registers" in line and fn is not None:
            regs = line.split("Used")[1].split("registers")[0].strip()
            rows.append(f"{fn}: {regs} registers, {spill} bytes spill stores")
            fn, spill = None, "0"
    return rows


def sass_mma_counts(lib) -> dict:
    """How many wgmma (HGMMA) and mma.sync (HMMA) instructions of each shape
    the built library holds, from ``cuobjdump -sass``."""
    from repro_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout
    counts = {}
    for word in sass.split():
        if word.startswith(("HGMMA.", "HMMA.")):
            counts[word] = counts.get(word, 0) + 1
    return counts


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


def cheb_attn_bwd_bound_ms(x, h_nb, mask, coeffs, dout, needs):
    """Least time for the backward on these inputs, computing the
    cotangents in ``needs``: x, h_nb, mask, coeffs and dout read once, each
    asked-for cotangent written once; or its float32 operations at peak
    (Horner for p and p', the recomputed out, the D-sums of g_e, den, dx;
    dh_nb, dmask and dcoeffs add theirs when asked for)."""
    outs = [x, h_nb, mask, coeffs]
    nbytes = 4 * (x.numel() + h_nb.numel() + mask.numel() + coeffs.numel() + dout.numel()
                  + sum(t.numel() for t, need in zip(outs, needs) if need))
    p1, d = coeffs.numel(), h_nb.shape[-1]
    per_score = 4 * p1 + 5 * d + 3
    per_score += 2 * d * needs[1] + 2 * needs[2] + 2 * p1 * needs[3]
    flops = x.numel() * per_score
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes


ARXIV_ROWS, ARXIV_B = 169_343, 32      # ogbn-arxiv's nodes, the benchmark's neighbour cap
GATHER_SHAPES = (("layer 1 scores", 8, 1), ("layer 2 scores", 1, 1), ("layer 2 rows", 1, 40))


def nbr_gather_phase(dev):
    """Phase 2c: the neighbour gathers' backward at the local step's three
    gathers (``GATHER_SHAPES``: H, F) over seeded padded lists of
    ogbn-arxiv's size (mean degree 13.77 plus a self-loop, padded slots on
    node 0, as ``csr_to_padded`` makes them). Each: the kernel against its
    plain version bit for bit and against PyTorch's index backward; the
    kernel with its plan and the plan alone (single-call medians), the
    bound (cotangent and int64 index read once, dx written once), the plain
    version and the index backward (the library yardstick). Returns the
    ``kernels`` line's entry, its top-level times at layer 2's rows."""
    from repro_torch.kernels.nbr_gather import (CHUNK, gather_plan, nbr_gather_backward,
                                                nbr_gather_backward_plain)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    deg = torch.poisson(torch.full((ARXIV_ROWS,), 13.77, device=dev), generator=gen) + 1
    deg = deg.clamp(max=ARXIV_B).long()
    idx = torch.randint(0, ARXIV_ROWS, (ARXIV_ROWS, ARXIV_B), generator=gen, device=dev)
    idx = torch.where(torch.arange(ARXIV_B, device=dev)[None] < deg[:, None], idx, 0)
    print(f"2c nbr_gather backward at ogbn-arxiv's size: {idx.numel()} slots, "
          f"{int((idx == 0).sum())} on node 0", flush=True)
    rows = {}
    for label, heads, f in GATHER_SHAPES:
        grad = torch.randn((heads, ARXIV_ROWS, ARXIV_B, f), generator=gen, device=dev)
        got = nbr_gather_backward(grad, idx, ARXIV_ROWS)
        if not torch.equal(got, nbr_gather_backward_plain(grad, idx, ARXIV_ROWS)):
            fail(f"2c nbr_gather backward ({label}): the kernel and its plain version differ")
        if not torch.equal(got, nbr_gather_backward(grad, idx, ARXIV_ROWS)):
            fail(f"2c nbr_gather backward ({label}): two launches give different bits")
        x = torch.zeros((heads, ARXIV_ROWS, f), device=dev, requires_grad=True)
        lib = torch.autograd.grad(x[:, idx, :], x, grad)[0]
        rel = float((got - lib).abs().max() / lib.abs().max())
        # Against the index backward in float64: the kernel adds float32
        # values along at most CHUNK additions a level, so each entry lies
        # within levels * CHUNK * 2**-24 of the sum of its terms' sizes.
        x64 = x.detach().double().requires_grad_(True)
        want = torch.autograd.grad(x64[:, idx, :], x64, grad.double())[0]
        size = torch.autograd.grad(x64[:, idx, :], x64, grad.double().abs())[0]
        n, levels = idx.numel(), 1
        while n > CHUNK:
            n, levels = 2 * -(-n // CHUNK), levels + 1
        over = float(((got.double() - want).abs() / (levels * CHUNK * F32_ULP * size + 1e-30))
                     .max())
        if not over <= 1.0:
            fail(f"2c nbr_gather backward ({label}): {over:.3f} of the float32 reordering "
                 "bound from the index backward in float64")
        del x64, want, size
        ms = cuda_ms(lambda: nbr_gather_backward(grad, idx, ARXIV_ROWS))
        plan_ms = cuda_ms(lambda: gather_plan(idx, ARXIV_ROWS))
        plain_ms = cuda_ms(lambda: nbr_gather_backward_plain(grad, idx, ARXIV_ROWS), reps=3,
                           warmup=1)
        library_ms = cuda_ms(lambda: torch.autograd.grad(x[:, idx, :], x, grad), reps=3,
                             warmup=1)
        nbytes = 4 * grad.numel() + 8 * idx.numel() + 4 * got.numel()
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        rows[label] = {"heads": heads, "f": f, "ms": ms, "plan_ms": plan_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms, "library_ms": library_ms,
                       "rel_err_vs_library": rel, "of_reordering_bound": over}
        print(f"2c nbr_gather backward {label} (H {heads}, F {f}): kernel {ms:.4f} ms (plan "
              f"{plan_ms:.4f}, levels {ms - plan_ms:.4f}), bound {bound_ms:.4f} ms (bytes, "
              f"{nbytes / 1e9:.3f} GB), {100 * bound_ms / ms:.1f}% of it; plain {plain_ms:.2f} ms "
              f"(equal bits); index backward {library_ms:.2f} ms, {rel:.2e} of max |dx| from "
              f"the kernel; {over:.3f} of the reordering bound (float64)", flush=True)
        del grad, got, x, lib
    torch.cuda.empty_cache()
    top = rows["layer 2 rows"]
    return {"max_abs_err": 0.0, "ms": top["ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"], "bound_by": "bytes", "library_ms": top["library_ms"],
            "by_shape": rows}


def wrapper_host_ms(fn, calls: int = 50) -> float:
    """Median host time of one call of ``fn`` (a kernel wrapper), on the host
    clock without a sync: what the wrapper spends before the launch
    returns. The calls queue on the card and are drained at the end."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def fwd_plan(x, h_nb, mask):
    """The cheb_attn forward's launch_plan for these inputs (as batched
    layouts), as the wrapper computes it."""
    import importlib

    from repro_torch.kernels.ref import _batched4

    mod = importlib.import_module("repro_torch.kernels.cheb_attn")

    x4, h4, m4 = _batched4(x, h_nb, mask)
    return mod.launch_plan(x4.shape[1], x4.shape[3], h4.shape[3], mod._aligned(x4, h4, m4))


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


def dcoeffs_abs_terms(x, h_nb, mask, coeffs, dout):
    """sum |g_e * m * x^k| per k, in float64: the scale of the dcoeffs sums.
    A row whose scores are equal across its neighbours has sum_b g_e = 0
    exactly, so its terms cancel and dcoeffs[k] can be far smaller than
    the terms it adds; any two float32 summation orders then differ by up
    to a few ulps of this scale."""
    from repro_torch.kernels.ref import _batched4

    x4, h4, m4 = (t.double() for t in _batched4(x, h_nb, mask))
    d4 = dout.double().reshape(x4.shape[:-1] + dout.shape[-1:])
    p = torch.zeros_like(x4)
    for q in coeffs.double().flip(0):
        p = p * x4 + q
    m = m4[:, None]
    e = p * m
    den = e.sum(-1, keepdim=True)
    ok = den != 0
    safe = torch.where(ok, den, 1.0)
    out = torch.where(ok, torch.einsum("ghnb,gnbd->ghnd", e, h4) / safe, 0.0)
    s = torch.einsum("ghnd,gnbd->ghnb", d4, h4) - (d4 * out).sum(-1, keepdim=True)
    t = (torch.where(ok, s / safe, 0.0) * m).abs()
    scale = []
    for _ in range(coeffs.numel()):
        scale.append(t.sum())
        t = t * x4.abs()
    return torch.stack(scale).float()


def compare_cheb_attn_backward(label, x, h_nb, mask, coeffs, dout, iso=(), nan_rows=()):
    """All four cotangents of the backward kernel against the plain
    backward, and dx against torch.autograd through the plain forward.
    dcoeffs is held to the same tolerance plus the float32 rounding of its
    sums, 64 ulp of sum |terms| (see :func:`dcoeffs_abs_terms`). Returns the
    largest absolute error of the other cotangents."""
    from repro_torch.kernels.cheb_attn import cheb_attn_backward
    from repro_torch.kernels.ref import cheb_attn_bwd_ref, cheb_attn_ref

    got = cheb_attn_backward(x, h_nb, mask, coeffs, dout)
    torch.cuda.synchronize()
    want = cheb_attn_bwd_ref(x, h_nb, mask, coeffs, dout)
    xg = x.detach().clone().requires_grad_()
    (auto_dx,) = torch.autograd.grad(cheb_attn_ref(xg, h_nb, mask, coeffs), xg, dout)
    del xg
    errs = []
    node_axis = {"dx": -2, "dh_nb": -3, "dmask": -2}
    for name, a, b in [*zip(("dx", "dh_nb", "dmask", "dcoeffs"), got, want),
                       ("dx vs autograd", got[0], auto_dx)]:
        if a.shape != b.shape:
            fail(f"cheb_attn backward {label} {name}: shape {tuple(a.shape)} != {tuple(b.shape)}")
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            fail(f"cheb_attn backward {label} {name}: NaN positions differ")
        ok = torch.isfinite(b)
        errs.append(float((a - b).abs()[ok].max()) if bool(ok.any()) else 0.0)
        if name == "dcoeffs":
            scale = dcoeffs_abs_terms(x, h_nb, mask, coeffs, dout)
            allow = GRAD_ATOL + GRAD_RTOL * b.abs() + 64 * F32_ULP * scale
            close = bool(((a - b).abs() <= allow)[ok].all())
        else:
            close = torch.allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL, equal_nan=True)
        if not close:
            fail(f"cheb_attn backward {label} {name}: kernel disagrees with the plain "
                 f"version (max abs err {errs[-1]:.3e})")
        if name in node_axis and not all(
                bool((a.select(a.dim() + node_axis[name], i) == 0).all()) for i in iso):
            fail(f"cheb_attn backward {label} {name}: isolated rows are not exact zeros")
    nans = all(bool(torch.isnan(got[0][..., i, :]).all()) for i in nan_rows)
    if not nans:
        fail(f"cheb_attn backward {label}: masked infinite scores did not give NaN rows")
    print(f"cheb_attn backward {label}: x{tuple(x.shape)} h_nb{tuple(h_nb.shape)} max_abs_err "
          f"dx {errs[0]:.3e} dh_nb {errs[1]:.3e} dmask {errs[2]:.3e} dcoeffs {errs[3]:.3e} "
          f"(largest sum|terms| {float(scale.max()):.3e}) "
          f"(dx vs autograd {errs[4]:.3e}) allclose(rtol={GRAD_RTOL},atol={GRAD_ATOL}; dcoeffs "
          f"+64ulp of sum|terms|)=True "
          f"isolated_rows_exact_zero=True nan_rows={len(nan_rows)}", flush=True)
    del got, want, auto_dx
    return max(errs[:3] + errs[4:])        # dcoeffs is judged on its own scale


def print_step_profile(step, label: str = "train step") -> float:
    """Device time of one call of ``step`` by kernel, from torch.profiler:
    prints the total over kernels and the five largest; returns the total
    (ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]          # kernels, not the ops that launch them
    total = sum(ms for _, ms in rows)
    top = sorted(rows, key=lambda r: -r[1])[:5]
    print(f"{label} profile (torch.profiler, {len(rows)} kernels): device total "
          f"{total:.3f} ms; " + "; ".join(
              f"{name[:70]} {ms:.3f} ms ({100 * ms / max(total, 1e-9):.1f}%)" for name, ms in top),
          flush=True)
    return total


def layer1_inputs(params, h, nbr_idx, nbr_mask):
    """What cheb_attn_layer hands the kernel (kernels/ops.py)."""
    from repro_torch.core.poly_attention import edge_scores, head_projections

    b1, b2 = head_projections(params)
    x = edge_scores(b1, b2, h, nbr_idx)
    mask_f = nbr_mask.to(h.dtype)
    return x, h[nbr_idx] * mask_f[..., None], mask_f


def bound(nbytes, flops, peak):
    """(bound ms, what sets it): the larger of bytes over HBM and flops over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def causal_pairs(s, causal=True):
    return s * (s + 1) // 2 if causal else s * s


def flash_bound(q, causal=True):
    """Each of q, k, v read once and out written once; the two products
    (4 hd flops per allowed pair) at the tensor-core rate for bf16 and the
    float32 rate for float32."""
    bt, heads, s, hd = q.shape
    flops = 4 * hd * bt * heads * causal_pairs(s, causal)
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    return bound(4 * q.numel() * q.element_size(), flops, peak)


def poly_bound(q, p1, causal=True):
    """q, k, v read once and out written once; per allowed pair the score's
    add and clip (3), Horner (2 per coefficient), the denominator (1) and
    e . v (2 hd); sq and sk (2 hd per row each) and the division. All in
    float32, as the TPU kernel computes them."""
    bt, heads, s, hd = q.shape
    flops = (bt * heads * causal_pairs(s, causal) * (3 + 2 * p1 + 1 + 2 * hd)
             + bt * heads * s * (4 * hd + hd))
    return bound(4 * q.numel() * q.element_size(), flops, FP32_FLOPS_PER_S)


def wkv_bound(r, c):
    """r, k, v, w read once, y written once (float32), S0 read and S_final
    written once. Per chunk the decay terms (8 per channel and step) on the
    CUDA cores in float32, and the products on the tensor cores in 3xTF32
    (three TF32 products each, as the fast path runs them): M (2 hd per pair
    below the diagonal, hd on it), y (2C + 2hd per output) and the state
    update (2C + 2 per entry)."""
    bh, s, hd = r.shape
    nbytes = 4 * r.numel() * r.element_size() + 4 * r.numel() + 2 * 4 * bh * hd * hd + 4 * hd
    products = c * (c - 1) * hd + c * hd + c * hd * (2 * c + 2 * hd) + hd * hd * (2 * c + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = bh * (s // c) * (8 * c * hd / FP32_FLOPS_PER_S + 3 * products / TF32_FLOPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def close(label, got, want, rtol, atol):
    """max abs error of ``got`` against ``want`` (both as float32), failing
    the run unless allclose at (rtol, atol)."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, rtol=rtol, atol=atol)
    print(f"  {label}: max_abs_err={err:.3e} max|want|={float(want.abs().max()):.3e} "
          f"allclose(rtol={rtol},atol={atol})={ok}", flush=True)
    if not ok:
        fail(f"{label}: kernel disagrees with its plain version")
    return err


def kernel_api_phase(dev, g, params, coeffs, h, nbr_idx, nbr_mask):
    """Phase 5: the kernel API at yi-6b's and rwkv6-1.6b's widths. Returns
    {kernel name: its JSON entry without name/route/source/replaces}, the
    cheb_attn launches of the bucketed layer, the largest error of cheb_attn
    against its plain version on the bucket shapes, and the largest error of
    the bucketed layer against the flat one."""
    from repro_torch.core.chebyshev import attention_series
    from repro_torch.kernels import flash_attn, ops, poly_attn, wkv_chunked
    from repro_torch.kernels.cheb_attn import cheb_attn
    from repro_torch.kernels.flash_attn import flash_attn_plain
    from repro_torch.kernels.poly_attn import poly_attn_plain
    from repro_torch.kernels.ref import poly_attn_ref, wkv_ref
    from repro_torch.kernels.wkv_chunk import wkv_chunked_plain

    (bt, heads, s, hd), (bh, s_w, hd_w) = YI6B_ATTN, RWKV6_WKV
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q, k, v = randn(bt, heads, s, hd), randn(bt, heads, s, hd), randn(bt, heads, s, hd)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    a1, a2 = randn(heads, hd) * hd**-0.5, randn(heads, hd) * hd**-0.5   # models/attention.py:52-53
    att8 = torch.as_tensor(attention_series(8, (-4.0, 4.0)), dtype=torch.float32, device=dev)
    r, kw, vw = randn(bh, s_w, hd_w), randn(bh, s_w, hd_w), randn(bh, s_w, hd_w)
    w = torch.sigmoid(randn(bh, s_w, hd_w) + 1.0) * 0.99                 # tests/test_kernels.py:203
    u = randn(hd_w) * 0.1
    S0 = randn(bh, hd_w, hd_w) * 0.1
    wkv_args = {"f32": (r, kw, vw, w), "bf16": tuple(t.bfloat16() for t in (r, kw, vw, w))}
    plan = ops.degree_bucket_plan(g.nbr_mask)
    plan_dev = [(torch.as_tensor(rows, device=dev), cap) for rows, cap in plan]
    torch.cuda.synchronize()

    import importlib

    from repro_torch.kernels.flash_attn import _alignment, launch_plan

    poly_plan = importlib.import_module("repro_torch.kernels.poly_attn").launch_plan
    wkv_mod = importlib.import_module("repro_torch.kernels.wkv_chunk")
    wkv_plans = {}
    for label, args in wkv_args.items():
        wkv_plans[label] = wkv_mod.launch_plan(hd_w, 16, args[0].dtype, _alignment(*args))
        print(f"wkv_chunked launch_plan {tuple(r.shape)} {label}: {wkv_plans[label]}", flush=True)
        if wkv_plans[label]["path"] != "fast":
            fail(f"wkv_chunked at rwkv6-1.6b's widths ({label}) takes the "
                 f"{wkv_plans[label]['path']} path, not the fast one")
    for qq in (qb, q):
        kk = kb if qq is qb else k
        dt = str(qq.dtype).replace('torch.', '')
        print(f"flash_attn launch_plan {tuple(qq.shape)} {dt}: "
              f"{launch_plan(s, hd, qq.dtype, _alignment(qq, kk))}", flush=True)
        print(f"poly_attn launch_plan {tuple(qq.shape)} {dt}: "
              f"{poly_plan(s, hd, qq.dtype, _alignment(kk))}", flush=True)
    counters = (flash_attn, poly_attn, wkv_chunked, cheb_attn)
    for fn in counters:
        fn.launches = 0
    with torch.inference_mode():
        out = {
            "flash bf16": flash_attn(qb, kb, vb, causal=True),
            "flash f32": flash_attn(q, k, v, causal=True),
            "poly f32": poly_attn(q, k, v, a1, a2, att8, causal=True),
            "poly bf16": poly_attn(qb, kb, vb, a1, a2, att8, causal=True),
            "poly f32 negated": poly_attn(q, k, v, a1, a2, -att8, causal=True),
            **{f"wkv {label}": wkv_chunked(*args, u, S0, chunk=16)
               for label, args in wkv_args.items()},
            "bucketed": ops.cheb_attn_layer_bucketed(params, coeffs, h, nbr_idx, nbr_mask,
                                                     plan=plan_dev),
        }
    torch.cuda.synchronize()
    got = {fn.__name__: fn.launches for fn in counters}
    want = {"flash_attn": 2, "poly_attn": 3, "wkv_chunked": 2, "cheb_attn": len(plan)}
    print(f"kernel API sbm_1m/yi-6b/rwkv6-1.6b: launches {got} (want {want}); "
          f"bucket plan {[(len(rows), cap) for rows, cap in plan]}", flush=True)
    if got != want:
        fail("the kernel-API phase's launch counts differ from its calls")

    errs = {"flash_attn": [], "poly_attn": [], "wkv_chunked": [], "wkv general": []}
    with torch.inference_mode():
        for label, (qq, kk, vv), tol in (("flash bf16", (qb, kb, vb), BF16_TOL),
                                         ("flash f32", (q, k, v), FLASH_TOL)):
            errs["flash_attn"].append(close(label, out.pop(label), flash_attn_plain(
                qq, kk, vv, causal=True), *tol))
        errs["poly_attn"].append(close("poly f32", out.pop("poly f32"), poly_attn_plain(
            q, k, v, a1, a2, att8), *POLY_TOL))
        errs["poly_attn"].append(close("poly bf16", out.pop("poly bf16"), poly_attn_plain(
            qb, kb, vb, a1, a2, att8), *BF16_TOL))
        # The oracle's max(den, 1e-9) guard keeps den's sign: with v = 1 its
        # output is den / max(den, 1e-9), negative exactly where den is.
        den = poly_attn_ref(q[:1, :1], k[:1, :1], a1[:1], a2[:1],
                            torch.ones_like(v[:1, :1]), -att8)
        print(f"  poly f32 negated: {int((den < 0).sum())} of {den.numel()} outputs of (b0, h0) "
              "have a negative denominator", flush=True)
        if not bool((den < 0).any()):
            fail("the negated series gave no negative denominator")
        errs["poly_attn"].append(close("poly f32 negated", out.pop("poly f32 negated"),
                                       poly_attn_plain(q, k, v, a1, a2, -att8), *POLY_TOL))
        # The fast path (counted above) and, outside the counted run, the
        # general kernel at the same shape, each held against the plain
        # version and the scan oracle.
        for label, args in wkv_args.items():
            results = {"wkv_chunked": out.pop(f"wkv {label}"),
                       "wkv general": wkv_mod._launch_general(*args, u, S0, 16)}
            py, psf = wkv_chunked_plain(*args, u, S0, chunk=16)
            t0 = time.perf_counter()
            ry, rsf = wkv_ref(*args, u, S0)
            scan_s = time.perf_counter() - t0
            for key, (y, sf) in results.items():
                name = f"wkv {label}" + (" general path" if key == "wkv general" else "")
                errs[key] += [close(f"{name} y", y, py, *WKV_TOL),
                              close(f"{name} S_final", sf, psf, *WKV_TOL),
                              close(f"{name} y vs scan oracle", y, ry, *WKV_TOL),
                              close(f"{name} S_final vs scan oracle", sf, rsf, *WKV_TOL)]
            print(f"  wkv {label}: max_abs_err fast path {max(errs['wkv_chunked'][-4:]):.3e}, "
                  f"general path {max(errs['wkv general'][-4:]):.3e}", flush=True)
            del py, psf, ry, rsf, results, y, sf
        from repro_torch.kernels.ops import cheb_attn_layer
        from repro_torch.kernels.ref import cheb_attn_ref
        x, h_nb, mask_f = layer1_inputs(params, h, nbr_idx, nbr_mask)
        bucket_kernel_err, bucket_rows = 0.0, []
        for rows, cap in plan_dev:
            xb_, hb_, mb_ = (x[:, rows, :cap].contiguous(), h_nb[rows, :cap].contiguous(),
                             mask_f[rows, :cap].contiguous())
            bucket_kernel_err = max(bucket_kernel_err, compare_cheb_attn(
                f"bucket cap {cap}", xb_, hb_, mb_, coeffs))
            # Each bucket's launch timed on its own inputs, beside its plan and bound.
            ob_ = cheb_attn(xb_, hb_, mb_, coeffs)
            bms, by, nbytes = cheb_attn_bound_ms(xb_, hb_, mb_, coeffs, ob_)
            bucket_rows.append(dict(
                cap=cap, rows=int(rows.numel()), plan=fwd_plan(xb_, hb_, mb_),
                ms=cuda_ms(lambda: cheb_attn(xb_, hb_, mb_, coeffs)),
                plain_ms=cuda_ms(lambda: cheb_attn_ref(xb_, hb_, mb_, coeffs), reps=5, warmup=1),
                bound_ms=bms, bound_by=by, gb=nbytes / 1e9))
            del xb_, hb_, mb_, ob_
        del x, h_nb, mask_f
        flat = cheb_attn_layer(params, coeffs, h, nbr_idx, nbr_mask)
        bucket_err = close("bucketed vs flat layer (sbm_1m)", out.pop("bucketed"), flat,
                           1e-6, 1e-6)                          # tests/test_bucketed_kernel.py:67
        del flat
    torch.cuda.empty_cache()

    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    with torch.inference_mode():
        for label, (qq, kk, vv) in (("bf16", (qb, kb, vb)), ("f32", (q, k, v))):
            rows[f"flash_attn {label}"] = dict(
                ms=cuda_ms(lambda: flash_attn(qq, kk, vv, causal=True)),
                plain_ms=cuda_ms(lambda: flash_attn_plain(qq, kk, vv, causal=True),
                                 reps=5, warmup=1),
                library_ms=cuda_ms(lambda: sdpa(qq, kk, vv, is_causal=True)),
                bound=flash_bound(qq))
        for label, (qq, kk, vv) in (("f32", (q, k, v)), ("bf16", (qb, kb, vb))):
            rows[f"poly_attn {label}"] = dict(
                ms=cuda_ms(lambda: poly_attn(qq, kk, vv, a1, a2, att8, causal=True)),
                plain_ms=cuda_ms(lambda: poly_attn_plain(qq, kk, vv, a1, a2, att8),
                                 reps=5, warmup=1),
                library_ms=None, bound=poly_bound(qq, att8.numel()))
        for label, args in wkv_args.items():
            rows[f"wkv_chunked {label}"] = dict(
                ms=cuda_ms(lambda: wkv_chunked(*args, u, S0, chunk=16)),
                plain_ms=cuda_ms(lambda: wkv_chunked_plain(*args, u, S0, chunk=16),
                                 reps=5, warmup=1),
                library_ms=None, bound=wkv_bound(args[0], 16))
        wkv_host_ms = wrapper_host_ms(lambda: wkv_chunked(r, kw, vw, w, u, S0, chunk=16))
        ms_bucketed = cuda_ms(lambda: ops.cheb_attn_layer_bucketed(
            params, coeffs, h, nbr_idx, nbr_mask, plan=plan_dev), reps=5)
        ms_flat = cuda_ms(lambda: cheb_attn_layer(params, coeffs, h, nbr_idx, nbr_mask), reps=5)
    smi = nvidia_smi()
    for name, row in rows.items():
        (bms, by) = row["bound"]
        lib = ("none" if row["library_ms"] is None
               else f"scaled_dot_product_attention {row['library_ms']:.4f} ms")
        print(f"{name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
              f"{bms:.4f} ms ({by}), library {lib}; {smi}", flush=True)
    for b in bucket_rows:
        print(f"cheb_attn bucket cap {b['cap']} ({b['rows']} rows): kernel {b['ms']:.4f} ms, "
              f"plain {b['plain_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
              f"{b['gb']:.3f} GB), launch_plan {b['plan']}; {smi}", flush=True)
    print(f"wkv_chunked f32: wrapper host time {wkv_host_ms:.4f} ms per call (host clock, no "
          f"sync, median of 50) beside its single-call median "
          f"{rows['wkv_chunked f32']['ms']:.4f} ms", flush=True)
    print(f"wkv scan oracle (wkv_ref, {s_w} Python steps): {scan_s:.2f} s wall; "
          f"sbm_1m layer 1: bucketed {ms_bucketed:.3f} ms, flat {ms_flat:.3f} ms; {smi}",
          flush=True)
    del q, k, v, qb, kb, vb, r, kw, vw, w, wkv_args, S0, out
    torch.cuda.empty_cache()

    def entry(name, row):
        bms, by = row["bound"]
        return {"launches": got[name], "max_abs_err": max(errs[name]), "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": bms, "bound_by": by,
                "library_ms": row["library_ms"]}

    flash = entry("flash_attn", rows["flash_attn bf16"])
    flash.update(ms_f32=rows["flash_attn f32"]["ms"],
                 library_ms_f32=rows["flash_attn f32"]["library_ms"])
    poly = entry("poly_attn", rows["poly_attn f32"])
    poly.update(ms_bf16=rows["poly_attn bf16"]["ms"],
                plain_ms_bf16=rows["poly_attn bf16"]["plain_ms"])
    wkv = entry("wkv_chunked", rows["wkv_chunked f32"])
    wkv.update(ms_bf16=rows["wkv_chunked bf16"]["ms"],
               plain_ms_bf16=rows["wkv_chunked bf16"]["plain_ms"],
               bound_ms_bf16=rows["wkv_chunked bf16"]["bound"][0], host_ms=wkv_host_ms,
               path=wkv_plans["f32"]["path"], max_abs_err_general=max(errs["wkv general"]))
    return {"flash_attn": flash, "poly_attn": poly, "wkv_chunked": wkv}, \
        len(plan), bucket_kernel_err, bucket_err, \
        {f"cap {b['cap']}": b["ms"] for b in bucket_rows}

MATRIX_TOL = (1e-3, 1e-4)    # tests/test_fedgat_engines.py:110
VECTOR_TOL = (1e-4, 1e-5)    # tests/test_fedgat_engines.py:121
MATRIX_PACK_BYTES_SBM_100K = 13_939_200_000     # N(g^2 + d g^2 + g + g d) * 4, N 1e5, d 32, g 32
VECTOR_PACK_BYTES_SBM_1M = 6_400_000_000        # (3 N d g + 2 N g) * 4, N 1e6, d 16, g 32


def pack_bytes(pack) -> int:
    return sum(t.numel() * t.element_size() for t in pack if isinstance(t, torch.Tensor))


def reckoned_pack_bytes(engine, n, d, b) -> int:
    g = 2 * b
    per_node = g * g + d * g * g + g + g * d if engine == "matrix" else 3 * d * g + 2 * g
    return 4 * n * per_node


def kernel_counters():
    from repro_torch.kernels import flash_attn, poly_attn, wkv_chunked
    from repro_torch.kernels.cheb_attn import cheb_attn, cheb_attn_backward
    from repro_torch.kernels.nbr_gather import nbr_gather_backward

    return (cheb_attn, cheb_attn_backward, flash_attn, nbr_gather_backward, poly_attn,
            wkv_chunked)


def zero_kernel_counts() -> None:
    for fn in kernel_counters():
        fn.launches = 0


# The neighbour gathers' backward kernels a local step launches, by engine:
# layer 2's score and row gathers (core/gat.py::gat_layer_nbr) in every
# engine, plus layer 1's score gather (core/poly_attention.py::edge_scores)
# in the kernel and direct engines, or both of layer 1's gathers in exact,
# whose layer 1 is a GAT layer. The pack engines' layer 1 gathers nothing
# that needs a gradient.
GATHER_BWD_PER_STEP = {"kernel": 3, "direct": 3, "matrix": 2, "vector": 2, "exact": 4}


class counted_steps:
    """Counts the trainer's local (or centralised) steps inside the block,
    as calls of ``federated.trainer.grad_of``: ``with counted_steps() as
    steps: ...; steps.n``."""

    def __enter__(self):
        from repro_torch.federated import trainer as fed_trainer

        self.n, self._mod, self._grad_of = 0, fed_trainer, fed_trainer.grad_of

        def counted(*args, **kwargs):
            self.n += 1
            return self._grad_of(*args, **kwargs)

        fed_trainer.grad_of = counted
        return self

    def __exit__(self, *exc):
        self._mod.grad_of = self._grad_of
        return False


class counted_gather_nodes:
    """Counts the autograd nodes the neighbour gathers build inside the block
    (``NbrGather.apply``: a gather on the card whose source needs a
    gradient), each of which must launch the gathers' backward once:
    ``with counted_gather_nodes() as nodes: ...; nodes.n``."""

    def __enter__(self):
        from repro_torch.kernels.nbr_gather import NbrGather

        self.n, self._cls, self._own = 0, NbrGather, NbrGather.__dict__.get("apply")
        apply = NbrGather.apply

        def counted(*args):
            self.n += 1
            return apply(*args)

        NbrGather.apply = counted
        return self

    def __exit__(self, *exc):
        if self._own is None:
            del self._cls.apply
        else:
            self._cls.apply = self._own
        return False


def check_no_kernel_launched(label: str, gather_bwd: int = 0) -> None:
    """Every kernel's count 0 (this path is plain PyTorch) but the neighbour
    gathers' backward, which the path's training steps launch
    ``gather_bwd`` times in all."""
    got = {fn.__name__: fn.launches for fn in kernel_counters()}
    want = {name: 0 for name in got}
    want["nbr_gather_backward"] = gather_bwd
    print(f"{label}: kernel launches {got} (want {want}: plain PyTorch but the training "
          "steps' gather backwards)", flush=True)
    if got != want:
        fail(f"{label}: the kernel launch counts differ from the reckoning")


def growth_delta(g, rng, m=64, per_node=2):
    """m new nodes, features copied from random old ones plus 0.01 noise (as
    the serve CLI makes them), each with ``per_node`` edges to random old
    nodes."""
    from repro_torch.serving import GraphDelta

    feats = g.features[rng.integers(0, g.num_nodes, size=m)]
    feats = feats + 0.01 * rng.standard_normal(feats.shape).astype(np.float32)
    new = np.repeat(np.arange(g.num_nodes, g.num_nodes + m), per_node)
    edges = np.stack([new, rng.integers(0, g.num_nodes, size=m * per_node)], axis=1)
    return GraphDelta(features=feats, edges=edges)


def serve_stream(server, n_q, seed, label, smi):
    """``n_q`` Poisson queries at 2000 qps over the server's clients through
    MicroBatcher (max batch 32); prints the latency summary. Returns the
    results."""
    from repro_torch.serving import MicroBatcher, Query

    rng = np.random.default_rng(seed)
    queries = [Query(int(c), int(v)) for c, v in zip(
        rng.integers(0, server.num_clients, size=n_q),
        rng.integers(0, server.graph.num_nodes, size=n_q))]
    arrivals = np.cumsum(rng.exponential(1.0 / 2000.0, size=n_q)).tolist()
    batcher = MicroBatcher(server.serve_batch, max_batch_size=32, max_wait=0.005)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    results = batcher.run(queries, arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = batcher.stats.summary()
    c = server.stats()["cache"]
    print(f"{label}: {n_q} queries, {int(s['batches'])} batches (mean {s['mean_batch']:.2f}), "
          f"p50 {s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms, {s['throughput_qps']:.1f} qps, "
          f"wall {wall:.3f} s with {c['misses']} pack builds; cache {c}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}", flush=True)
    if len(results) != n_q or any(not np.isfinite(r.logits).all() for r in results):
        fail(f"{label}: served results are missing or not finite")
    return results


def check_served(label, results, want, tol, client=None):
    mine = [r for r in results if client is None or r.client == client]
    got = np.stack([r.logits for r in mine])
    ref = want[[r.node for r in mine]]
    err = float(np.abs(got - ref).max())
    ok = got.shape[1] == want.shape[1] and np.allclose(got, ref, rtol=tol[0], atol=tol[1])
    print(f"  {label}: {len(mine)} answers, max abs err {err:.3e} "
          f"allclose(rtol={tol[0]},atol={tol[1]})={ok}", flush=True)
    if not ok:
        fail(f"{label}: served logits disagree")
    return err


def pack_engines_phase(dev, g1m, params1m, want_direct1m, big="sbm_100k", mid="sbm_10k",
                       small="tiny"):
    """Phase 6: the paper's pack engines (no kernel on this path but the
    gathers' backward in training).

    6a: Matrix FedGAT on ``big`` (sbm_100k) at FedGATConfig() widths: the
    pack build, forwards, federated training and serving with a delta
    absorbed by patches; the refreshes on ``mid`` (sbm_10k).
    6b: Vector FedGAT on ``g1m`` (sbm_1m) serving 4 clients with a delta.
    6c: distgat through the exact engine on ``g1m``, 4 clients.
    6d: matrix training on ``small`` on the card against the CPU, one pack."""
    from repro_torch.core import FedGAT, FedGATConfig, get_engine, init_params, layered_forward
    from repro_torch.core.fedgat_model import graph_tensors
    from repro_torch.federated import FederatedConfig, run_federated
    from repro_torch.federated import trainer as fed_trainer
    from repro_torch.federated.partition import client_neighbor_masks, dirichlet_partition
    from repro_torch.graphs import make_cora_like, make_sbm
    from repro_torch.serving import GraphInferenceServer, Query
    from repro_torch.serving.updates import extend_coverage, initial_coverage, mass_drift

    smi = nvidia_smi()

    # -- 6a: matrix at sbm_100k -------------------------------------------
    t0 = time.perf_counter()
    g = make_sbm(big, seed=SEED)
    cfg = FedGATConfig()
    params = init_params(torch.Generator().manual_seed(SEED), g.feature_dim, g.num_classes,
                         cfg, device=dev)
    h, idx, mask = graph_tensors(g, dev)
    coeffs = torch.as_tensor(cfg.coeffs(), dtype=torch.float32, device=dev)
    engines = {name: get_engine(name)(cfg) for name in ("matrix", "direct", "kernel")}
    print(f"phase 6a {big}: N={g.num_nodes} d={g.feature_dim} B={g.max_degree} "
          f"C={g.num_classes}; FedGATConfig() engine={cfg.engine} hidden {cfg.hidden} heads "
          f"{cfg.heads} degree {cfg.degree} basis {cfg.basis}; built in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    zero_kernel_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pack = engines["matrix"].precompute(torch.Generator(device=dev).manual_seed(SEED),
                                        h, idx, mask)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    nbytes = pack_bytes(pack)
    want_bytes = reckoned_pack_bytes("matrix", g.num_nodes, g.feature_dim, g.max_degree)
    g2 = 2 * g.max_degree
    normal = torch.randn((g.num_nodes, g2, g2), device=dev)
    qr_s = cuda_ms(lambda: torch.linalg.qr(normal), reps=1, warmup=0) / 1e3
    del normal
    print(f"matrix pack build {big}: {build_s:.3f} s, of which torch.linalg.qr of "
          f"{g.num_nodes} {g2}x{g2} matrices {qr_s:.3f} s; pack bytes {nbytes} (reckoned "
          f"{want_bytes}); peak {build_peak:.2f} GiB; {smi}", flush=True)
    if nbytes != want_bytes or (big == "sbm_100k" and nbytes != MATRIX_PACK_BYTES_SBM_100K):
        fail("the matrix pack's size differs from its reckoning")
    with torch.inference_mode():
        ms = {}
        for name in ("matrix", "direct"):
            eng, pk = engines[name], (pack if name == "matrix" else None)
            ms[f"layer1 {name}"] = cuda_ms(lambda: eng.apply(
                params[0], pk, coeffs, h, idx, mask), reps=5, warmup=1)
            ms[f"forward {name}"] = cuda_ms(lambda: layered_forward(
                eng, params, coeffs, pk, h, idx, mask), reps=5, warmup=1)
        torch.cuda.reset_peak_memory_stats()
        logits_m = layered_forward(engines["matrix"], params, coeffs, pack, h, idx, mask)
        fwd_peak = torch.cuda.max_memory_allocated() / 2**30
        want_direct = layered_forward(engines["direct"], params, coeffs, None,
                                      h, idx, mask).cpu().numpy()
    got = logits_m.cpu().numpy()
    err = float(np.abs(got - want_direct).max())
    ok = np.isfinite(got).all() and np.allclose(got, want_direct, *MATRIX_TOL)
    print(f"matrix logits vs direct {big}: max abs err {err:.3e} (max |logit| "
          f"{float(np.abs(want_direct).max()):.3e}) allclose(rtol={MATRIX_TOL[0]},"
          f"atol={MATRIX_TOL[1]})={ok}; forward peak {fwd_peak:.2f} GiB", flush=True)
    if not ok:
        fail("matrix logits disagree with the direct engine")
    del logits_m

    fed_cfg = FederatedConfig(method="fedgat", num_clients=4, beta=1.0, rounds=3, local_steps=3,
                              aggregator="fedavg", lr=0.01, seed=SEED, model=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counted_steps() as steps_6a:
        res = run_federated(g, fed_cfg, device=dev)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    s_round = res["seconds"] / fed_cfg.rounds
    print(f"train {big}: fedgat matrix engine, 4 clients, 3 rounds x 3 local steps: "
          f"{s_round:.3f} s per round (trainer clock), wall {train_wall:.2f} s with the pack "
          f"build; peak {train_peak:.2f} GiB; val {res['val_curve']} test "
          f"{res['test_curve']}; {smi}", flush=True)
    if not all(bool(torch.isfinite(p).all()) for p in res["params"].parameters()):
        fail("phase 6a: trained params are not finite")
    _, forward = fed_trainer.build_forward(fed_cfg, g, dev, pack=pack)
    labels = torch.as_tensor(g.labels, dtype=torch.int64, device=dev)
    tr_mask = (torch.as_tensor(res["partition"].owner == 0, device=dev)
               & torch.as_tensor(g.train_mask, device=dev))
    loss_fn = fed_trainer.make_loss_fn(forward, labels)
    tparams = fed_trainer.param_tree(res["params"])
    with counted_steps() as timed_6a:
        ms["train step"] = cuda_ms(lambda: fed_trainer.grad_of(loss_fn, tparams, mask, tr_mask),
                                   reps=3, warmup=1)
        print(f"train step {big} (device, matrix engine): forward+backward "
              f"{ms['train step']:.3f} ms", flush=True)
        print_step_profile(lambda: fed_trainer.grad_of(loss_fn, tparams, mask, tr_mask))
    del forward, loss_fn, tparams, res, pack
    torch.cuda.empty_cache()

    # Serving at `big`, at refresh_threshold 1e9: the delta is absorbed by
    # patches alone. A refresh is a full build at the grown graph's padded
    # degree, which apply_delta lifts (it re-symmetrises the degree-capped
    # neighbour lists: B 16 -> 32 at sbm_100k), so its size is reckoned here
    # and the refreshes run at `mid`.
    server = GraphInferenceServer(params, cfg, g, num_clients=2, refresh_threshold=1e9,
                                  device=dev)
    results = serve_stream(server, 128, SEED, f"serve {big} matrix", smi)
    check_served("matrix served vs direct", results, want_direct, MATRIX_TOL)
    rng = np.random.default_rng(SEED + 1)
    delta = growth_delta(g, rng)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rep = server.apply_update(delta)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    cache = server.stats()["cache"]
    new_g = server.graph
    print(f"delta {big} matrix: +{rep['new_nodes']} nodes +{rep['new_edges']} edges in "
          f"{update_s:.3f} s; eps {rep['drift']} refreshed {rep['refreshed']}; cache {cache}; "
          f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    if cache["patches"] != 2 or rep["refreshed"]:
        fail(f"phase 6a: {cache['patches']} patches (want 2), refreshed {rep['refreshed']}")
    cov = extend_coverage(initial_coverage(g), new_g, g.max_degree)
    cpu_params = [{k: v.detach().cpu() for k, v in layer.items()} for layer in params]
    eps_cpu = mass_drift(cpu_params[0], coeffs.cpu(), cfg.basis, cfg.domain, new_g, cov)
    for c, eps in rep["drift"].items():
        if not np.isclose(eps, eps_cpu, rtol=1e-5, atol=0.0):
            fail(f"phase 6a: client {c}'s eps {eps!r} differs from the CPU copy's {eps_cpu!r}")
    grown = reckoned_pack_bytes("matrix", new_g.num_nodes, new_g.feature_dim, new_g.max_degree)
    g4 = 2 * new_g.max_degree
    print(f"  eps on the card {sorted(rep['drift'].values())} vs mass_drift on a CPU copy "
          f"{eps_cpu!r} (rtol 1e-5): equal; Thm 3.5 bound {server.drift(0)['bound']:.4f} "
          f"(the default threshold 2.0 would refresh); the grown graph has B="
          f"{new_g.max_degree}, so a refreshed pack would hold {grown} bytes and its "
          f"projectors {4 * new_g.num_nodes * new_g.max_degree * g4 * g4} more while it "
          "builds", flush=True)
    del server
    torch.cuda.empty_cache()

    # Refreshes at `mid`, FedGATConfig() widths, the same delta recipe.
    gm = make_sbm(mid, seed=SEED)
    pm = init_params(torch.Generator().manual_seed(SEED), gm.feature_dim, gm.num_classes,
                     cfg, device=dev)
    server = GraphInferenceServer(pm, cfg, gm, num_clients=2, device=dev)
    server.serve_batch([Query(0, 1), Query(1, 2)])
    delta_m = growth_delta(gm, rng)
    rep = server.apply_update(delta_m)
    new_g = server.graph
    print(f"delta {mid} matrix: B {gm.max_degree} -> {new_g.max_degree}; eps {rep['drift']} "
          f"refreshed {rep['refreshed']} at the default threshold 2.0; cache "
          f"{server.stats()['cache']}", flush=True)
    if server.stats()["cache"]["patches"] != 2:
        fail("phase 6a: not every resident client was patched")
    server.refresh(0)
    with torch.no_grad():
        fresh = server.engine.precompute(server._client_gen(0), server._h, server._idx,
                                         server._mask)
    same = all(torch.equal(a, b) for a, b in zip(server.pack_for(0), fresh)
               if isinstance(a, torch.Tensor))
    print(f"  refresh(0) vs a from-scratch precompute under client 0's generator: bitwise "
          f"equal {same}", flush=True)
    if not same:
        fail("phase 6a: refresh(0) is not bit for bit a from-scratch build")
    del fresh
    new_h, new_idx, new_mask = graph_tensors(new_g, dev)
    with torch.inference_mode():
        want_new = layered_forward(engines["direct"], pm, coeffs, None,
                                   new_h, new_idx, new_mask).cpu().numpy()
    del new_h, new_idx, new_mask
    nodes = list(range(new_g.num_nodes))
    after = server.serve_batch([Query(0, v) for v in nodes])
    check_served(
        "client 0 after refresh vs direct on the grown graph", after, want_new, MATRIX_TOL)
    del server, after
    server = GraphInferenceServer(pm, cfg, gm, num_clients=2, refresh_threshold=1e-9,
                                  device=dev)
    server.serve_batch([Query(0, 1), Query(1, 2)])
    rep2 = server.apply_update(delta_m)
    print(f"  refresh_threshold 1e-9: refreshed {rep2['refreshed']}, cache "
          f"{server.stats()['cache']}", flush=True)
    if rep2["refreshed"] != [0, 1]:
        fail("phase 6a: a server at refresh_threshold 1e-9 did not refresh every client")
    del server, pm
    torch.cuda.empty_cache()
    steps_6a = steps_6a.n + timed_6a.n
    check_no_kernel_launched(f"phase 6a ({big}, matrix; {steps_6a} local steps, timed ones "
                             "included)", GATHER_BWD_PER_STEP["matrix"] * steps_6a)
    # Outside the counted run: the kernel engine's times on the same inputs.
    with torch.inference_mode():
        ms["layer1 kernel"] = cuda_ms(lambda: engines["kernel"].apply(
            params[0], None, coeffs, h, idx, mask), reps=5, warmup=1)
        ms["forward kernel"] = cuda_ms(lambda: layered_forward(
            engines["kernel"], params, coeffs, None, h, idx, mask), reps=5, warmup=1)
    print(f"forward {big} (device, median of 5): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ms.items() if k != "train step")
        + f"; kernel engine timed outside the counted run; {smi}", flush=True)
    del params, h, idx, mask, want_direct, want_new
    torch.cuda.empty_cache()

    # -- 6b: vector at sbm_1m, 4 clients ----------------------------------
    zero_kernel_counts()
    vcfg = FedGATConfig(engine="vector")
    h1, idx1, mask1 = graph_tensors(g1m, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vpack = get_engine("vector")(vcfg).precompute(
        torch.Generator(device=dev).manual_seed(SEED), h1, idx1, mask1)
    torch.cuda.synchronize()
    vbuild_s = time.perf_counter() - t0
    vbytes = pack_bytes(vpack)
    vwant = reckoned_pack_bytes("vector", g1m.num_nodes, g1m.feature_dim, g1m.max_degree)
    print(f"vector pack build sbm_1m: {vbuild_s:.3f} s; pack bytes {vbytes} (reckoned "
          f"{vwant}); peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}",
          flush=True)
    if vbytes != vwant or (g1m.num_nodes == 1_000_000 and vbytes != VECTOR_PACK_BYTES_SBM_1M):
        fail("the vector pack's size differs from its reckoning")
    with torch.inference_mode():
        ms_v = cuda_ms(lambda: layered_forward(get_engine("vector")(vcfg), params1m, coeffs,
                                               vpack, h1, idx1, mask1), reps=5, warmup=1)
    del vpack
    torch.cuda.empty_cache()
    # refresh_threshold 1e9: four refreshes at the grown B (12.8 GB a pack)
    # would crowd the card; client 0 is refreshed by hand below.
    server = GraphInferenceServer(params1m, vcfg, g1m, num_clients=4, refresh_threshold=1e9,
                                  device=dev)
    results = serve_stream(server, 128, SEED + 2, "serve sbm_1m vector", smi)
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    check_served("vector served vs direct", results, want_direct1m, VECTOR_TOL)
    rng = np.random.default_rng(SEED + 3)
    delta = growth_delta(g1m, rng)
    t0 = time.perf_counter()
    rep = server.apply_update(delta)
    torch.cuda.synchronize()
    vupdate_s = time.perf_counter() - t0
    print(f"delta sbm_1m vector: +{rep['new_nodes']} nodes in {vupdate_s:.3f} s; eps "
          f"{rep['drift']} (Thm 3.5 bound {server.drift(0)['bound']:.4f}) refreshed "
          f"{rep['refreshed']}; cache {server.stats()['cache']}", flush=True)
    if server.stats()["cache"]["patches"] != len(rep["drift"]):
        fail("phase 6b: not every resident client was patched")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server.refresh(0)
    torch.cuda.synchronize()
    new_g = server.graph
    print(f"  refresh(0): {time.perf_counter() - t0:.3f} s at B={new_g.max_degree}, pack bytes "
          f"{pack_bytes(server.pack_for(0))}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)
    new_h, new_idx, new_mask = graph_tensors(new_g, dev)
    with torch.inference_mode():
        want_new = layered_forward(get_engine("direct")(vcfg), params1m, coeffs, None,
                                   new_h, new_idx, new_mask).cpu().numpy()
    del new_h, new_idx, new_mask
    nodes = list(range(0, new_g.num_nodes, 9973)) + list(range(g1m.num_nodes, new_g.num_nodes))
    after = server.serve_batch([Query(0, v) for v in nodes])
    check_served("client 0 after refresh vs direct on the grown graph", after, want_new,
                 VECTOR_TOL)
    del server, after, want_new
    torch.cuda.empty_cache()
    check_no_kernel_launched("phase 6b (sbm_1m, vector)")
    print(f"vector sbm_1m: full forward {ms_v:.3f} ms (device, median of 5); serving peak "
          f"{serve_peak:.2f} GiB with 4 packs; {smi}", flush=True)

    # -- 6c: distgat through the exact engine at sbm_1m, 4 clients ------
    zero_kernel_counts()
    part = dirichlet_partition(g1m.labels, 4, 1.0, SEED)
    dcfg = FedGATConfig(engine="exact")
    server = GraphInferenceServer(params1m, dcfg, g1m, method="distgat", num_clients=4,
                                  partition=part, device=dev)
    results = serve_stream(server, 128, SEED + 4, "serve sbm_1m distgat exact", smi)
    vis = client_neighbor_masks(g1m, part)
    exact = get_engine("exact")(dcfg)
    worst = 0.0
    for c in range(4):
        mine = [r for r in results if r.client == c]
        if not mine:
            continue
        with torch.inference_mode():
            want = layered_forward(exact, params1m, None, None, h1, idx1,
                                   torch.as_tensor(vis[c], device=dev)).cpu().numpy()
        got = np.stack([r.logits for r in mine])
        diff = float(np.abs(got - want[[r.node for r in mine]]).max())
        worst = max(worst, diff)
        if diff != 0.0:
            fail(f"phase 6c: client {c}'s distgat logits differ from layered_forward under "
                 f"its own mask (max abs {diff:.3e})")
    print(f"  distgat: every client's answers equal layered_forward(exact, its own mask) "
          f"(max abs {worst:.1e})", flush=True)
    del server, vis, h1, idx1, mask1
    torch.cuda.empty_cache()
    check_no_kernel_launched("phase 6c (sbm_1m, distgat exact)")

    # -- 6d: matrix training on a small graph, card against CPU ----------
    zero_kernel_counts()
    tiny = make_cora_like(small, seed=SEED)
    tcfg = FederatedConfig(method="fedgat", num_clients=4, beta=1.0, rounds=3, local_steps=3,
                           aggregator="fedavg", seed=SEED, model=FedGATConfig())
    tpack = FedGAT(tcfg.model, device="cpu").precommunicate(
        fed_trainer.pack_generator(SEED, "cpu"), tiny)
    with counted_steps() as steps_6d:
        on_gpu = run_federated(tiny, tcfg, device=dev, pack=tpack)
    on_cpu = run_federated(tiny, tcfg, device="cpu", pack=tpack)
    curves = (np.allclose(on_gpu["val_curve"], on_cpu["val_curve"], atol=1e-6)
              and np.allclose(on_gpu["test_curve"], on_cpu["test_curve"], atol=1e-6))
    perr = max(float((a.detach().cpu() - b.detach()).abs().max())
               for a, b in zip(on_gpu["params"].parameters(), on_cpu["params"].parameters()))
    pclose = all(torch.allclose(a.detach().cpu(), b.detach(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
                 for a, b in zip(on_gpu["params"].parameters(), on_cpu["params"].parameters()))
    print(f"{small} matrix training check: one CPU-built pack, card vs CPU curves equal (atol "
          f"1e-6) {curves}, final params max abs diff {perr:.3e} allclose(rtol={GRAD_RTOL},"
          f"atol={GRAD_ATOL}) {pclose}; val {on_gpu['val_curve']}", flush=True)
    if not (curves and pclose):
        fail(f"{small}: matrix training on the card disagrees with the CPU")
    check_no_kernel_launched(f"phase 6d ({small}, matrix training; {steps_6d.n} local steps on "
                             "the card)", GATHER_BWD_PER_STEP["matrix"] * steps_6d.n)


def params_max_diff(a, b) -> float:
    return max(float((p.detach().cpu() - q.detach().cpu()).abs().max())
               for p, q in zip(a.parameters(), b.parameters()))


def host_named(params):
    """A result's params as (name, host tensor) pairs; such pairs (a
    worker's, or phase 4's kept on the host) pass through."""
    if isinstance(params, torch.nn.Module):
        return [(n, p.detach().cpu()) for n, p in params.named_parameters()]
    return params


def output_a1_apart(a, b):
    """Two runs' final params as host pairs: (every leaf but the output
    layer's ``a1``, that leaf). The output layer's ``a1`` reaches the logits
    only through the leaky ReLU's kink, so its gradient is mostly float32
    rounding noise that Adam scales into steps: from round 2 on it carries
    any earlier rounding difference (tests/test_torch_federated.py's
    docstring; ROADMAP Queue 3)."""
    a, b = host_named(a), host_named(b)
    out_a1 = f"{len({n.split('.')[0] for n, _ in a}) - 1}.a1"
    rest, a1 = [], None
    for (name, p), (_, q) in zip(a, b):
        if name == out_a1:
            a1 = (p, q)
        else:
            rest.append((p, q))
    return rest, a1


def max_diff(pairs) -> float:
    return max(float((p - q).abs().max()) for p, q in pairs)


def all_close(pairs) -> bool:
    return all(torch.allclose(p, q, rtol=GRAD_RTOL, atol=GRAD_ATOL) for p, q in pairs)


def params_finite(res) -> bool:
    return all(bool(torch.isfinite(p).all()) for p in res["params"].parameters())


def counted_run(label, g, cfg, dev, want_fwd, want_bwd):
    """``run_federated`` through the kernel engine on the card with the
    kernel counts zeroed just before and read just after; fails unless they
    equal the wants, the gathers' backward 3 a local step (one a ``cheb_attn``
    backward). Returns (result, forward launches, backward launches, gather
    backward launches, peak GiB)."""
    from repro_torch.federated import run_federated
    from repro_torch.kernels.cheb_attn import cheb_attn, cheb_attn_backward
    from repro_torch.kernels.nbr_gather import nbr_gather_backward

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    res = run_federated(g, cfg, device=dev)
    torch.cuda.synchronize()
    fwd, bwd = cheb_attn.launches, cheb_attn_backward.launches
    gather = nbr_gather_backward.launches
    want_gather = GATHER_BWD_PER_STEP["kernel"] * want_bwd
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"{label}: {res['seconds'] / max(cfg.rounds, 1):.3f} s per round (trainer clock), "
          f"peak {peak:.2f} GiB; launches forward {fwd} (want {want_fwd}), backward {bwd} "
          f"(want {want_bwd}), gather backward {gather} (want {want_gather}); cohort "
          f"{res['cohort']}; val {res['val_curve']}", flush=True)
    if (fwd, bwd, gather) != (want_fwd, want_bwd, want_gather):
        fail(f"{label}: the kernel launch counts differ from the cohort plans'")
    if not params_finite(res):
        fail(f"{label}: trained params are not finite")
    return res, fwd, bwd, gather, peak


def cohort_privacy_phase(dev, big="sbm_100k", mid="sbm_10k", small="tiny"):
    """Phase 7: cohort streaming and the privacy stack (see the module
    docstring). Returns the ``cheb_attn`` forward and backward launches and
    the gather backward's of its counted runs (7a-7d)."""
    from dataclasses import replace

    from repro_torch import telemetry
    from repro_torch.core import FedGAT, FedGATConfig
    from repro_torch.federated import FederatedConfig, run_federated
    from repro_torch.federated import trainer as fed_trainer
    from repro_torch.federated.cohort import cohort_lanes, plan_rounds
    from repro_torch.graphs import make_cora_like, make_sbm
    from repro_torch.privacy import (
        PrivacyConfig,
        compute_epsilon,
        noisy_pack,
        pack_noise_key,
        pack_release_steps,
        pack_sensitivities,
    )
    from repro_torch.privacy.attacks import run_membership_inference

    smi = nvidia_smi()
    t0 = time.perf_counter()
    g = make_sbm(big, seed=SEED)
    print(f"phase 7 {big}: N={g.num_nodes} d={g.feature_dim} B={g.max_degree} "
          f"C={g.num_classes}; built in {time.perf_counter() - t0:.1f}s; {smi}", flush=True)
    cohort_fwd = cohort_bwd = cohort_gather = 0

    def plan_launches(cfg):
        _, chosen = fed_trainer.selection_schedule(cfg)
        plans = plan_rounds(cfg, chosen, cohort_lanes(cfg))
        live = [int((p.weights > 0).sum()) for p in plans]
        steps = cfg.local_steps
        return plans, live, sum(n * steps + 1 for n in live), sum(n * steps for n in live)

    # -- 7a: sync cohorts against the Trainer's loop ------------------------
    cfg = FederatedConfig(method="fedgat", num_clients=64, beta=1.0, rounds=2, local_steps=3,
                          client_fraction=0.25, aggregator="fedavg", seed=SEED,
                          model=FedGATConfig(engine="kernel"), max_concurrent_clients=4)
    n_sel = fed_trainer.num_selected(cfg)
    want_fwd = cfg.rounds * (n_sel * cfg.local_steps + 1)
    want_bwd = cfg.rounds * n_sel * cfg.local_steps
    res, fwd, bwd, gather, peak = counted_run(
        f"7a {big} sync cohorts (K 64, {n_sel} per round, lanes 4)", g, cfg, dev,
        want_fwd, want_bwd)
    cohort_fwd, cohort_bwd = cohort_fwd + fwd, cohort_bwd + bwd
    cohort_gather += gather
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop = run_federated(g, replace(cfg, max_concurrent_clients=None), device=dev)
    torch.cuda.synchronize()
    loop_peak = torch.cuda.max_memory_allocated() / 2**30
    curves = (np.allclose(res["val_curve"], loop["val_curve"], atol=1e-6)
              and np.allclose(res["test_curve"], loop["test_curve"], atol=1e-6))
    diff = params_max_diff(res["params"], loop["params"])
    rest, a1 = output_a1_apart(res["params"], loop["params"])
    print(f"7a against the loop (max_concurrent_clients=None): {loop['seconds'] / cfg.rounds:.3f}"
          f" s per round, peak {loop_peak:.2f} GiB; curves equal (atol 1e-6) {curves}; final "
          f"params max abs diff {diff:.3e}: every leaf but the output layer's a1 "
          f"{max_diff(rest):.3e} (limit 1e-5), that a1 {max_diff([a1]):.3e} "
          f"(allclose(rtol={GRAD_RTOL},atol={GRAD_ATOL}) {all_close([a1])})", flush=True)
    if not (curves and max_diff(rest) <= 1e-5 and all_close([a1])):
        fail("7a: sync cohorts disagree with the Trainer's loop")
    del res, loop

    # -- 7b: buffered with churn --------------------------------------------
    bcfg = replace(cfg, aggregation_mode="buffered", staleness_power=0.5,
                   churn_drop_rate=0.2, churn_join_rate=0.02)
    plans, live, want_fwd, want_bwd = plan_launches(bcfg)
    joined0 = telemetry.counter("federated.cohort.joined").value
    dropped0 = telemetry.counter("federated.cohort.dropped").value
    res, fwd, bwd, gather, _ = counted_run(f"7b {big} buffered, churn (live per round {live})",
                                           g, bcfg, dev, want_fwd, want_bwd)
    cohort_fwd, cohort_bwd = cohort_fwd + fwd, cohort_bwd + bwd
    cohort_gather += gather
    joined = (sum(p.joined for p in plans),
              telemetry.counter("federated.cohort.joined").value - joined0)
    dropped = (sum(p.dropped for p in plans),
               telemetry.counter("federated.cohort.dropped").value - dropped0)
    print(f"7b churn: joined {res['cohort']['joined']} (plan {joined[0]}, counter {joined[1]}), "
          f"dropped {res['cohort']['dropped']} (plan {dropped[0]}, counter {dropped[1]})",
          flush=True)
    if (res["cohort"]["joined"] != joined[0] or joined[0] != joined[1]
            or res["cohort"]["dropped"] != dropped[0] or dropped[0] != dropped[1]):
        fail("7b: the churn report differs from the plans or the counters")
    del res

    # -- 7c: DP with pairwise secure aggregation ----------------------------
    priv = PrivacyConfig(clip=1.0, noise_multiplier=0.5, secure_agg=True,
                         secure_agg_mode="pairwise")
    ccfg = replace(cfg, privacy=priv)
    res, fwd, bwd, gather, _ = counted_run(
        f"7c {big} DP (clip 1, sigma 0.5) + pairwise masks", g, ccfg, dev,
        cfg.rounds * (n_sel * cfg.local_steps + 1), cfg.rounds * n_sel * cfg.local_steps)
    cohort_fwd, cohort_bwd = cohort_fwd + fwd, cohort_bwd + bwd
    cohort_gather += gather
    again = run_federated(g, ccfg, device=dev)
    same = (res["val_curve"] == again["val_curve"] and res["test_curve"] == again["test_curve"])
    eps = compute_epsilon(priv.noise_multiplier, cfg.rounds, n_sel / cfg.num_clients,
                          priv.delta)
    one = replace(ccfg, rounds=1)
    on = run_federated(g, one, device=dev)
    off = run_federated(g, replace(one, privacy=replace(priv, secure_agg=False)), device=dev)
    mask_diff = params_max_diff(on["params"], off["params"])
    print(f"7c: a second run's curves identical {same}; epsilon {res['epsilon']!r} "
          f"(compute_epsilon {eps!r}); one round with masks against without: params max abs "
          f"diff {mask_diff:.3e} (limit 1e-5)", flush=True)
    if not same or res["epsilon"] != eps or not np.isfinite(eps) or mask_diff > 1e-5:
        fail("7c: DP with pairwise masks is not deterministic, exact or accounted")
    del res, again, on, off

    # -- 7d: the secure-aggregation protocol with dropouts ------------------
    dcfg = replace(cfg, num_clients=16, client_fraction=1.0, aggregation_mode="buffered",
                   churn_drop_rate=0.25, privacy=PrivacyConfig(secure_agg=True))
    plans, live, want_fwd, want_bwd = plan_launches(dcfg)
    recovered0 = telemetry.counter("privacy.secure_agg.recovered_seeds").value
    failures0 = telemetry.counter("privacy.secure_agg.recovery_failures").value
    telemetry.reset()
    telemetry.enable()
    try:
        res, fwd, bwd, gather, _ = counted_run(
            f"7d {big} protocol, buffered, drop churn 0.25 (K 16, lanes 4, live {live})",
            g, dcfg, dev, want_fwd, want_bwd)
        host = {}
        for r in telemetry.records():
            if r.name in ("secure_agg_setup", "secure_agg_mask", "aggregate"):
                host[r.name] = host.get(r.name, 0.0) + r.dur_ns / 1e9
    finally:
        telemetry.disable()
        telemetry.reset()
    cohort_fwd, cohort_bwd = cohort_fwd + fwd, cohort_bwd + bwd
    cohort_gather += gather
    recovered = telemetry.counter("privacy.secure_agg.recovered_seeds").value - recovered0
    failures = telemetry.counter("privacy.secure_agg.recovery_failures").value - failures0
    free = run_federated(g, replace(dcfg, privacy=PrivacyConfig()), device=dev)
    curves = (np.allclose(res["val_curve"], free["val_curve"], atol=1e-6)
              and np.allclose(res["test_curve"], free["test_curve"], atol=1e-6))
    rest, a1 = output_a1_apart(res["params"], free["params"])
    diff, pclose = max_diff(rest + [a1]), all_close(rest + [a1])
    # The reference's exactness test is one round (tests/test_secure_protocol.py:
    # 262-272): from round 2 on, Adam carries the quantization's rounding.
    one = replace(dcfg, rounds=1)
    one_diff = params_max_diff(run_federated(g, one, device=dev)["params"], run_federated(
        g, replace(one, privacy=PrivacyConfig()), device=dev)["params"])
    n_dropped = sum(p.dropped for p in plans)
    print(f"7d: dropped {n_dropped} in the plans ({plans[0].dropped} in round 1), recovered "
          f"seeds {recovered}, rounds below the Shamir threshold re-run among the survivors "
          f"{failures}; against the mask-free run of the same churn: curves equal (atol 1e-6) "
          f"{curves}, params max abs diff {diff:.3e} (allclose(rtol={GRAD_RTOL},atol={GRAD_ATOL})"
          f" {pclose}), after round 1 alone {one_diff:.3e} (limit 1e-5); protocol host seconds "
          f"{sum(host.values()):.3f} (" + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(host.items())) + ")", flush=True)
    if (n_dropped and recovered <= 0) or not (curves and pclose and one_diff <= 1e-5):
        fail("7d: the protocol did not recover its dropouts or is not exact")
    del res, free
    del g
    torch.cuda.empty_cache()

    # -- 7e: pack noise, matrix at sbm_10k and vector at sbm_100k -----------
    sigma = 0.5
    for engine, name in (("matrix", mid), ("vector", big)):
        gp = make_sbm(name, seed=SEED)
        mcfg = FedGATConfig(engine=engine)
        zero_kernel_counts()
        clean = FedGAT(mcfg, device=dev).precommunicate(fed_trainer.pack_generator(SEED, dev), gp)
        sens = pack_sensitivities(clean, gp.features)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        noised = noisy_pack(pack_noise_key(SEED), clean, gp.features, sigma)
        torch.cuda.synchronize()
        noise_s = time.perf_counter() - t0
        rows = []
        for field, s in sens.items():
            d = getattr(noised, field) - getattr(clean, field)
            std = float(d.std())
            rows.append((field, d.numel(), std, sigma * s))
            del d
        print(f"7e {engine} {name}: noised in {noise_s:.3f} s; per field (elements, std, "
              f"sigma*sensitivity): " + "; ".join(
                  f"{f} {n} {s:.6f} {w:.6f}" for f, n, s, w in rows), flush=True)
        if any(abs(s - w) > 0.01 * w for _, _, s, w in rows):
            fail(f"7e {engine}: a noised field's std is not within 1% of sigma*sensitivity")
        if engine == "vector" and not torch.equal(noised.mask4, clean.mask4):
            fail("7e vector: the slot indicator mask4 was noised")
        del clean, noised
        torch.cuda.empty_cache()
        # The training round. Matrix FedGAT diverges to non-finite params at
        # sigma 0.5 in both packages (the noised pack drives layer-1 scores
        # out of the series' domain), so its round runs at the reference's
        # own trainer-test multiplier, 0.05 (tests/test_privacy.py:403).
        train_sigma = 0.05 if engine == "matrix" else sigma
        tcfg = FederatedConfig(method="fedgat", num_clients=4, beta=1.0, rounds=1, local_steps=3,
                               seed=SEED, model=mcfg,
                               privacy=PrivacyConfig(pack_noise_multiplier=train_sigma))
        torch.cuda.reset_peak_memory_stats()
        with counted_steps() as steps_7e:
            res = run_federated(gp, tcfg, device=dev)
        torch.cuda.synchronize()
        want_eps = compute_epsilon(train_sigma, pack_release_steps(), 1.0, tcfg.privacy.delta)
        print(f"7e {engine} {name} training round at pack sigma {train_sigma}: "
              f"{res['seconds']:.3f} s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB,"
              f" params finite {params_finite(res)}, pack_epsilon {res['privacy']['pack_epsilon']!r}"
              f" (accountant {want_eps!r}); val {res['val_curve']}", flush=True)
        if not params_finite(res) or res["privacy"]["pack_epsilon"] != want_eps:
            fail(f"7e {engine}: the noised-pack round is not finite or not accounted")
        check_no_kernel_launched(f"7e ({engine}, {name}; {steps_7e.n} local steps)",
                                 GATHER_BWD_PER_STEP[engine] * steps_7e.n)
        del res, gp
        torch.cuda.empty_cache()

    # -- 7f: distgat staging, cohorts against the loop -----------------------
    g = make_sbm(big, seed=SEED)
    fcfg = FederatedConfig(method="distgat", num_clients=256, beta=1.0, rounds=2, local_steps=3,
                           client_fraction=1 / 16, seed=SEED, max_concurrent_clients=4,
                           model=FedGATConfig(engine="exact"))
    lanes = cohort_lanes(fcfg)
    zero_kernel_counts()
    peaks = {}
    runs = {}
    steps_7f = 0
    for label, c in (("cohort", fcfg), ("loop", replace(fcfg, max_concurrent_clients=None))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with counted_steps() as steps:
            runs[label] = run_federated(g, c, device=dev)
        steps_7f += steps.n
        torch.cuda.synchronize()
        peaks[label] = torch.cuda.max_memory_allocated() / 2**30
    n, b, K = g.num_nodes, g.max_degree, fcfg.num_clients
    curves = (np.allclose(runs["cohort"]["val_curve"], runs["loop"]["val_curve"], atol=1e-6)
              and np.allclose(runs["cohort"]["test_curve"], runs["loop"]["test_curve"], atol=1e-6))
    print(f"7f distgat {big} (K {K}, {fed_trainer.num_selected(fcfg)} per round, lanes {lanes}): "
          f"cohort {runs['cohort']['seconds'] / fcfg.rounds:.3f} s per round, peak "
          f"{peaks['cohort']:.3f} GiB, staging {lanes * n * b / 1e6:.1f} MB of masks per cohort; "
          f"loop {runs['loop']['seconds'] / fcfg.rounds:.3f} s per round, peak "
          f"{peaks['loop']:.3f} GiB, staging K*N*B = {K * n * b / 1e6:.1f} MB; curves equal "
          f"(atol 1e-6) {curves}; {smi}", flush=True)
    if not curves:
        fail("7f: distgat cohorts disagree with the loop")
    check_no_kernel_launched(f"7f (distgat exact, {big}; {steps_7f} local steps)",
                             GATHER_BWD_PER_STEP["exact"] * steps_7f)
    del runs, g
    torch.cuda.empty_cache()

    # -- 7g: the card against the CPU on tiny -------------------------------
    tiny = make_cora_like(small, seed=SEED)
    gcfg = replace(cfg, num_clients=4, client_fraction=1.0, max_concurrent_clients=2,
                   privacy=PrivacyConfig(clip=1.0, noise_multiplier=0.5))
    on_gpu = run_federated(tiny, gcfg, device=dev)
    on_cpu = run_federated(tiny, gcfg, device="cpu")
    curves = (np.allclose(on_gpu["val_curve"], on_cpu["val_curve"], atol=1e-6)
              and np.allclose(on_gpu["test_curve"], on_cpu["test_curve"], atol=1e-6))
    # The output layer's a1 is rounding noise on tiny (output_a1_apart;
    # tests/test_torch_federated.py leaves it out for the same reason).
    rest, a1 = output_a1_apart(on_gpu["params"], on_cpu["params"])
    pclose = all_close(rest)
    mia_gpu = run_membership_inference(tiny, gcfg, device=dev)
    mia_cpu = run_membership_inference(tiny, gcfg, device="cpu")
    print(f"7g {small} DP cohorts (K 4, lanes 2): card vs CPU curves equal (atol 1e-6) {curves}, "
          f"params max abs diff {params_max_diff(on_gpu['params'], on_cpu['params']):.3e}, "
          f"every leaf but the output layer's a1 allclose(rtol={GRAD_RTOL},atol={GRAD_ATOL}) "
          f"{pclose} (that a1 {max_diff([a1]):.3e}, not held); MIA advantage card "
          f"{mia_gpu['advantage']!r} CPU {mia_cpu['advantage']!r} (auc {mia_gpu['auc']!r} / "
          f"{mia_cpu['auc']!r})", flush=True)
    if not (curves and pclose) or mia_gpu["advantage"] != mia_cpu["advantage"]:
        fail(f"7g: {small} DP cohort training or the MIA audit differs between card and CPU")
    return cohort_fwd, cohort_bwd, cohort_gather


# Phase 8's worker: one rank of a shard_map run on the card. It zeroes its
# own launch counts just before run_federated and reads them just after
# (counts are per process), and prints its rank, collectives, launches and a
# sha256 of its final params on a line of its own; the parent reads the
# same record, with the params, from the rank's file.
RANK_WORKER = r"""
import hashlib, json, sys, time
import torch
from repro_torch.launch import multiprocess as mp
rank, nproc, collectives = mp.initialize_worker(device="cuda")
import torch.distributed as dist
try:
    from repro_torch.core import FedGATConfig
    from repro_torch.federated import FederatedConfig, run_federated
    from repro_torch.graphs import make_sbm
    from repro_torch.kernels.cheb_attn import cheb_attn, cheb_attn_backward
    from repro_torch.kernels.nbr_gather import nbr_gather_backward
    from repro_torch.privacy import PrivacyConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    kw = dict(spec["cfg"])
    cfg = FederatedConfig(model=FedGATConfig(engine="kernel"),
                          privacy=PrivacyConfig(**kw.pop("privacy", {})), **kw)
    g = make_sbm(spec["graph"], seed=cfg.seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cheb_attn.launches = cheb_attn_backward.launches = nbr_gather_backward.launches = 0
    t0 = time.perf_counter()
    res = run_federated(g, cfg, backend="shard_map")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd, bwd = cheb_attn.launches, cheb_attn_backward.launches
    gather = nbr_gather_backward.launches
    named = [(n, p.detach().cpu()) for n, p in res["params"].named_parameters()]
    digest = hashlib.sha256()
    for n, p in named:
        digest.update(n.encode() + p.numpy().tobytes())
    rec = {"rank": rank, "processes": nproc, "collectives": collectives,
           "device": f"cuda:{torch.cuda.current_device()}", "forward": fwd, "backward": bwd,
           "gather_backward": gather,
           "params_sha256": digest.hexdigest(), "s_per_round": res["seconds"] / cfg.rounds,
           "run_s": wall, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "val_curve": res["val_curve"], "test_curve": res["test_curve"],
           "epsilon": res["epsilon"], "mesh": res["mesh"]}
    print(f"rank {rank}: " + json.dumps(rec), flush=True)
    torch.save({**rec, "params": named}, f"{out}/rank{rank}.pt")
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""


def rank_launches(cfg, processes):
    """Each rank's exact (forward, backward) cheb_attn and gather backward
    launches in a shard_map run: a selected client it hosts runs
    ``local_steps`` of each a round, and rank 0 one evaluation forward a
    round."""
    from repro_torch.federated import trainer as fed_trainer

    sel, _ = fed_trainer.selection_schedule(cfg)
    per = cfg.num_clients // processes
    want = []
    for r in range(processes):
        steps = int(sel[:, r * per:(r + 1) * per].sum()) * cfg.local_steps
        want.append((steps + (cfg.rounds if r == 0 else 0), steps,
                     GATHER_BWD_PER_STEP["kernel"] * steps))
    return want


def run_ranks(label, graph, cfg, processes=2):
    """``cfg`` over ``processes`` ranks on this host's card(s) through
    ``launch``; fails unless every rank exits 0 with its exact launch counts
    and the ranks' params hash equal. Returns (rank records, wall s)."""
    import tempfile
    from dataclasses import asdict

    from repro_torch.launch import multiprocess as mp

    spec = {k: v for k, v in asdict(cfg).items() if k not in ("model", "privacy", "backend")}
    spec["privacy"] = asdict(cfg.privacy)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + os.pathsep + env.get("PYTHONPATH", "")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        code = mp.launch([sys.executable, "-c", RANK_WORKER, tmp,
                          json.dumps({"graph": graph, "cfg": spec})],
                         processes=processes, devices_per_process=cfg.num_clients // processes,
                         timeout=600, env=env)
        wall = time.perf_counter() - t0
        if code != 0:
            fail(f"{label}: a worker exited {code}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(processes)]
    want = rank_launches(cfg, processes)
    got = [(r["forward"], r["backward"], r["gather_backward"]) for r in ranks]
    rule = mp.collectives_for("cuda", processes)
    print(f"{label}: {processes} ranks, collectives {[r['collectives'] for r in ranks]} (rule for "
          f"{torch.cuda.device_count()} card(s): {rule}), devices {[r['device'] for r in ranks]}; "
          f"s per round {[round(r['s_per_round'], 3) for r in ranks]} (trainer clock), run "
          f"{[round(r['run_s'], 2) for r in ranks]} s, wall {wall:.2f} s with start-up; peak "
          f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; launches (forward, backward, gather "
          f"backward) per rank "
          f"{got} (want {want}); params sha256 {[r['params_sha256'][:16] for r in ranks]}",
          flush=True)
    if got != want:
        fail(f"{label}: the per-rank kernel launch counts differ from the schedule's")
    if len({r["params_sha256"] for r in ranks}) != 1:
        fail(f"{label}: the ranks' final params differ")
    if any(r["collectives"] != rule for r in ranks):
        fail(f"{label}: the ranks did not take the collectives rule's {rule}")
    mesh = {"axis_names": ["clients"], "axis_sizes": [cfg.num_clients],
            "num_devices": processes, "num_processes": processes, "platform": "gpu"}
    if any(r["mesh"] != mesh for r in ranks):
        fail(f"{label}: mesh {ranks[0]['mesh']} is not {mesh}")
    return ranks, wall


def against(label, got, want_curves, want_params, curve_atol=1e-6):
    """Curves to ``curve_atol``; params to 1e-5 on every leaf but the output
    layer's ``a1``, that leaf at phase 4's tolerance (output_a1_apart)."""
    curves = (np.allclose(got["val_curve"], want_curves[0], atol=curve_atol)
              and np.allclose(got["test_curve"], want_curves[1], atol=curve_atol))
    rest, a1 = output_a1_apart(got["params"], want_params)
    ok = curves and max_diff(rest) <= 1e-5 and all_close([a1])
    print(f"{label}: curves equal (atol {curve_atol}) {curves}; final params every leaf but the "
          f"output layer's a1 {max_diff(rest):.3e} (limit 1e-5), that a1 {max_diff([a1]):.3e} "
          f"(allclose(rtol={GRAD_RTOL},atol={GRAD_ATOL}) {all_close([a1])})", flush=True)
    if not ok:
        fail(f"{label}: the distributed run disagrees with its reference run")


def distributed_phase(dev, phase4, big="sbm_1m", small="sbm_100k"):
    """Phase 8: the shard_map backend (see the module docstring).
    ``phase4`` holds phase 4's config, curves and final params on the
    host. Returns the ``cheb_attn`` forward and backward launches and the
    gather backward's of its counted runs, over every rank."""
    from dataclasses import replace

    from repro_torch.core import FedGATConfig
    from repro_torch.federated import FederatedConfig, run_federated
    from repro_torch.graphs import make_sbm
    from repro_torch.privacy import PrivacyConfig

    smi = nvidia_smi()
    g = make_sbm(small, seed=SEED)
    print(f"phase 8 {small}: N={g.num_nodes}; {smi}", flush=True)

    # -- 8a: one process: one-lane cohorts against the loop ----------------
    cfg = FederatedConfig(method="fedgat", num_clients=4, beta=1.0, rounds=2, local_steps=3,
                          aggregator="fedavg", seed=SEED, model=FedGATConfig(engine="kernel"))
    want_fwd = cfg.rounds * (cfg.num_clients * cfg.local_steps + 1)
    want_bwd = cfg.rounds * cfg.num_clients * cfg.local_steps
    t0 = time.perf_counter()
    res, fwd, bwd, gather, _ = counted_run(f"8a {small} shard_map, one process (K 4)", g,
                                   replace(cfg, backend="shard_map"), dev, want_fwd, want_bwd)
    print(f"8a: wall {time.perf_counter() - t0:.2f} s with set-up; mesh {res['mesh']}", flush=True)
    if res["mesh"] != {"axis_names": ["lanes"], "axis_sizes": [1], "num_devices": 1,
                       "num_processes": 1, "platform": "gpu"}:
        fail(f"8a: the one-process mesh is {res['mesh']}, not one lane")
    loop = run_federated(g, cfg, device=dev)
    print(f"8a loop: {loop['seconds'] / cfg.rounds:.3f} s per round (trainer clock)", flush=True)
    against("8a against the loop", res, (loop["val_curve"], loop["test_curve"]), loop["params"])
    dist_fwd, dist_bwd, dist_gather = fwd, bwd, gather
    del res, loop

    # -- 8b: two processes on the card, phase 4's config --------------------
    ranks, _ = run_ranks(f"8b {big} fedavg K 4, 3 rounds x 3 steps", big, phase4["cfg"])
    against("8b rank 0 against phase 4", ranks[0], phase4["curves"], phase4["params"])
    dist_fwd += sum(r["forward"] for r in ranks)
    dist_bwd += sum(r["backward"] for r in ranks)
    dist_gather += sum(r["gather_backward"] for r in ranks)

    # -- 8c: two processes, DP with pairwise masks --------------------------
    pcfg = replace(cfg, num_clients=8, client_fraction=0.5,
                   privacy=PrivacyConfig(clip=1.0, noise_multiplier=0.5, secure_agg=True,
                                         secure_agg_mode="pairwise"))
    ranks, _ = run_ranks(f"8c {small} DP (clip 1, sigma 0.5) + pairwise masks, K 8, fraction "
                         "0.5", small, pcfg)
    loop = run_federated(g, pcfg, device=dev)
    curves = (np.allclose(ranks[0]["val_curve"], loop["val_curve"], atol=1e-6)
              and np.allclose(ranks[0]["test_curve"], loop["test_curve"], atol=1e-6))
    rest, a1 = output_a1_apart(ranks[0]["params"], loop["params"])
    print(f"8c against the single-process loop: curves equal (atol 1e-6) {curves}; epsilon "
          f"{ranks[0]['epsilon']!r} (loop {loop['epsilon']!r}); final params every leaf but the "
          f"output layer's a1 {max_diff(rest):.3e}, that a1 {max_diff([a1]):.3e} (not held)",
          flush=True)
    if not curves or ranks[0]["epsilon"] != loop["epsilon"] or loop["epsilon"] is None:
        fail("8c: the private distributed run disagrees with the loop")
    dist_fwd += sum(r["forward"] for r in ranks)
    dist_bwd += sum(r["backward"] for r in ranks)
    dist_gather += sum(r["gather_backward"] for r in ranks)
    return dist_fwd, dist_bwd, dist_gather


# -- phase 9: the language-model substrate ----------------------------------

YI6B_PARAMS = 6_061_035_520      # 32 x 173,023,232 a layer + 2 x 64000 x 4096 + 4096
RWKV6_PARAMS = 1_580_795_904     # 24 x 54,681,600 a layer + 2 x 65536 x 2048 + 2048
GRANITE_PARAMS = 1_385_481_216   # 24 x 53,512,192 a layer + 2 x 49408 x 1024 + 1024
ARCH_RTOL, ARCH_ATOL = 5e-3, 5e-4    # tests/test_archs.py:85-97, float32


def tree_bytes(tree) -> int:
    from repro_torch._tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tree_numel(tree) -> int:
    from repro_torch._tree import tree_leaves

    return sum(t.numel() for t in tree_leaves(tree))


def lm_leaves(obj, prefix=""):
    """{path: tensor} over dicts and (named) tuples; None (a family's absent
    cache part) gives nothing."""
    if obj is None:
        return {}
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    items = (obj.items() if isinstance(obj, dict) else
             zip(obj._fields, obj) if hasattr(obj, "_fields") else enumerate(obj))
    out = {}
    for k, v in items:
        out.update(lm_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def lm_close(label, got, want, rtol, atol) -> float:
    """Every leaf of ``got`` (on the card) against ``want`` (on the CPU);
    fails on a missing leaf or a value outside the tolerance. Returns the
    largest absolute difference."""
    g, w = lm_leaves(got), lm_leaves(want)
    if sorted(g) != sorted(w):
        fail(f"{label}: leaves differ: {sorted(set(g) ^ set(w))}")
    worst = 0.0
    for k in w:
        a, b = g[k].detach().cpu(), w[k].detach()
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{label} {k}: {tuple(a.shape)} {a.dtype} against {tuple(b.shape)} {b.dtype}")
        if a.is_floating_point():
            a, b = a.float(), b.float()
            worst = max(worst, float((a - b).abs().max()) if a.numel() else 0.0)
            if not torch.allclose(a, b, rtol=rtol, atol=atol):
                fail(f"{label} {k}: card and CPU differ (max abs {float((a - b).abs().max()):.3e},"
                     f" rtol {rtol} atol {atol})")
        elif not torch.equal(a, b):
            fail(f"{label} {k}: card and CPU differ")
    return worst


def arch_property(label, dev, cfg, seq=64, cache_len=128):
    """The reference's prefill/decode property (tests/test_archs.py:59-97)
    at ``cfg``'s widths in float32 on the card: prefill logits at the last
    prompt position against the full forward, then one decode step against
    the full forward at the next position."""
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf

    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED + 1), dev)
    tok = torch.randint(0, cfg.vocab_size, (2, seq), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    with torch.no_grad():
        full = tf.lm_forward(params, cfg, tok)[0]
        lg_pf, cache = model.prefill(params, {"tokens": tok[:, :seq - 1], "cache_len": cache_len})
        lg_dec, _ = model.decode_step(params, cache, tok[:, seq - 1:])
    errs = (float((lg_pf[:, -1] - full[:, -2]).abs().max()),
            float((lg_dec[:, 0] - full[:, -1]).abs().max()))
    ok = (torch.allclose(lg_pf[:, -1], full[:, -2], rtol=ARCH_RTOL, atol=ARCH_ATOL)
          and torch.allclose(lg_dec[:, 0], full[:, -1], rtol=ARCH_RTOL, atol=ARCH_ATOL))
    print(f"{label}: float32 at full width, {cfg.num_layers} layers, {tree_numel(params):,} "
          f"params, S {seq}: prefill vs forward max abs {errs[0]:.3e}, decode vs forward "
          f"{errs[1]:.3e} (rtol {ARCH_RTOL} atol {ARCH_ATOL}) {ok}", flush=True)
    if not ok:
        fail(f"{label}: prefill/decode disagree with the full forward")
    del params, full, cache
    torch.cuda.empty_cache()


def serve_full(label, dev, name, reckoned, batch, prompt, gen, smi):
    """``name``'s full config (bf16) through the serve CLI's lm path."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models import build_model

    cfg = get_config(name)
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n, nbytes = tree_numel(params), tree_bytes(params)
    print(f"{label} {name}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.dtype}; params "
          f"{n:,} (reckoned {reckoned:,}), {nbytes:,} bytes allocated (reckoned "
          f"{2 * reckoned:,}); init {init_s:.2f} s", flush=True)
    if n != reckoned or nbytes != 2 * reckoned:
        fail(f"{label}: {name}'s params differ from the reckoned count")
    gen_t = torch.Generator(device=dev).manual_seed(SEED + 3)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), device=dev, generator=gen_t)
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    res = serve_lm(model, params, {"tokens": tokens}, gen, prompt + gen + 8)
    check_no_kernel_launched(f"{label} ({name} serving)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = gen - 1
    print(f"{label} {name}: batch {batch}, prompt {prompt}, gen {gen} greedy: prefill "
          f"{res['prefill_s']:.3f} s ({batch * prompt / res['prefill_s']:.0f} tok/s), decode "
          f"{1e3 * res['decode_s'] / steps:.2f} ms a token ({steps * batch / res['decode_s']:.1f} "
          f"tok/s over {steps} steps), peak {peak:.2f} GiB; {smi}", flush=True)
    toks = res["tokens"]
    if not bool(torch.isfinite(res["prefill_logits"]).all()) or toks.shape != (batch, gen) \
            or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size:
        fail(f"{label}: {name}'s logits are not finite or its tokens leave the vocab")
    # After the counts were read: the device time of one decode step.
    with torch.no_grad():
        dev_ms = print_step_profile(
            lambda: model.decode_step(params, res["cache"], toks[:, -1:]),
            f"{label} {name} decode step")
    wall_ms = 1e3 * res["decode_s"] / steps
    print(f"{label} {name}: decode device time {dev_ms:.3f} ms of {wall_ms:.3f} ms a token: "
          f"device idle {100 * (1 - dev_ms / wall_ms):.1f}%; {smi}", flush=True)
    del params, res
    torch.cuda.empty_cache()
    return cfg


def train_full(dev, smi):
    """9c: granite-moe-1b-a400m's full config through the train CLI's lm
    path: 20 steps, batch 4, seq 1024."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_lm_batches
    from repro_torch.launch.train import train_lm
    from repro_torch.models import build_model
    from repro_torch.models import transformer as tf

    name, steps, batch, seq = "granite-moe-1b-a400m", 20, 4, 1024
    cfg = get_config(name)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(SEED), dev)
    n = tree_numel(params)
    print(f"9c {name}: {cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_experts} experts "
          f"top-{cfg.experts_per_token}, vocab {cfg.padded_vocab()}; params {n:,} (reckoned "
          f"{GRANITE_PARAMS:,}), {tree_bytes(params):,} bytes", flush=True)
    if n != GRANITE_PARAMS or cfg.padded_vocab() != 49408:
        fail("9c: granite's params differ from the reckoned count")
    drops = []
    moe_ffn = tf.moe_ffn

    def recorded(p, c, x):        # moe_drop_frac, which lm_loss does not return
        out, aux = moe_ffn(p, c, x)
        drops.append(aux["moe_drop_frac"].detach())
        return out, aux

    batches = make_lm_batches(cfg.vocab_size, batch, seq, seed=SEED)
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    tf.moe_ffn = recorded
    try:
        res = train_lm(cfg, params, batches, steps, log_every=5, batch_tokens=batch * seq)
    finally:
        tf.moe_ffn = moe_ffn
    check_no_kernel_launched(f"9c ({name} training)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = res["losses"]
    drop = torch.stack(drops).float()
    dtypes = {str(t.dtype) for t in lm_leaves(res["params"]).values()}
    print(f"9c {name}: {steps} steps x batch {batch} x seq {seq}: {res['seconds'] / steps:.3f} s "
          f"a step, {steps * batch * seq / res['seconds']:.0f} tok/s, peak {peak:.2f} GiB; "
          f"moe_drop_frac mean {float(drop.mean()):.4f} max {float(drop.max()):.4f} over "
          f"{drop.numel()} layer calls; param dtypes {sorted(dtypes)}; losses "
          f"{[round(x, 4) for x in losses]}; {smi}", flush=True)
    first, last5 = losses[0], sum(losses[-5:]) / 5
    if not all(np.isfinite(losses)):
        fail("9c: a loss is not finite")
    if abs(first - np.log(cfg.padded_vocab())) >= 1.5:
        fail(f"9c: the first loss {first:.4f} is not within 1.5 of log(49408)")
    if not last5 < first:
        fail(f"9c: the mean of the last 5 losses {last5:.4f} is not below the first {first:.4f}")
    if dtypes != {"torch.float32"}:
        fail(f"9c: param dtypes after training are {dtypes}, not float32")
    # After the counts were read: the device time of one more step.
    from repro_torch.launch.steps import make_train_step

    step_fn = make_train_step(cfg)
    b = {k: torch.from_numpy(v).to(dev) for k, v in next(batches).items()}
    dev_ms = print_step_profile(lambda: step_fn(res["params"], res["opt"], b),
                                f"9c {name} train step")
    wall_ms = 1e3 * res["seconds"] / steps
    print(f"9c {name}: step device time {dev_ms:.1f} ms of {wall_ms:.1f} ms a step (the run's "
          f"mean, step 0 in bf16 included): device idle {100 * (1 - dev_ms / wall_ms):.1f}%; "
          f"{smi}", flush=True)
    del res, params, b
    torch.cuda.empty_cache()


def archs_card_vs_cpu(dev):
    """9d: every assigned arch's reduced() config, params drawn once on the
    CPU and copied to the card: forward, prefill (logits and cache), one
    decode step, the loss, the grads and one train step, card against CPU."""
    from repro_torch._tree import tree_map
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.launch.steps import adam_init_f32, make_train_step, value_and_grad
    from repro_torch.models import build_model
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tf

    B, S = 2, 16
    rows = []
    zero_kernel_counts()
    for name in ASSIGNED_ARCHS:
        cfg = get_config(name).reduced()
        model = build_model(cfg)
        cpu = model.init(torch.Generator().manual_seed(SEED), "cpu")
        card = tree_map(lambda t: t.to(dev), cpu)
        rng = np.random.default_rng(SEED)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
                 "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
        if cfg.family == "vlm":
            batch["prefix"] = rng.standard_normal((B, cfg.prefix_len, cfg.d_model)).astype(
                np.float32)
        if cfg.is_encdec:
            batch["frames"] = rng.standard_normal((B, S // cfg.encoder_ratio, cfg.d_model)).astype(
                np.float32)

        def run(params, device):
            b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
            out = {}
            with torch.no_grad():
                if cfg.is_encdec:
                    memory = ed.encode(params, cfg, b["frames"])
                    out["forward"] = ed.decode_train(params, cfg, b["tokens"], memory)
                else:
                    out["forward"] = tf.lm_forward(params, cfg, b["tokens"], prefix=b.get("prefix"),
                                                   coeffs=tf.cheb_coeffs(cfg))[0]
                pb = {k: v for k, v in b.items() if k != "labels"}
                pb["tokens"], pb["cache_len"] = b["tokens"][:, :S - 1], 32
                out["prefill"] = model.prefill(params, pb)
                out["decode"] = model.decode_step(params, out["prefill"][1], b["tokens"][:, S - 1:])
            loss, parts, grads = value_and_grad(model.loss, params, b)
            out["loss"], out["parts"], out["grads"] = loss, parts, grads
            stepped, _, step_loss = make_train_step(cfg)(params, adam_init_f32(params), b)
            out["step"] = (stepped, step_loss)
            return out

        got, want = run(card, dev), run(cpu, "cpu")
        errs = {
            "forward": lm_close(f"9d {name} forward", got["forward"], want["forward"], RTOL, ATOL),
            "prefill": lm_close(f"9d {name} prefill", got["prefill"], want["prefill"], RTOL, ATOL),
            "decode": lm_close(f"9d {name} decode", got["decode"], want["decode"], RTOL, ATOL),
            "loss": lm_close(f"9d {name} loss", (got["loss"], got["parts"]),
                             (want["loss"], want["parts"]), RTOL, ATOL),
            "grads": lm_close(f"9d {name} grads", got["grads"], want["grads"],
                              LM_GRAD_RTOL, ATOL),
        }
        # One AdamW step: where |g| < 1e-6 (100 x Adam's eps) the update
        # lr g / (|g| + eps) turns gradient rounding into up to lr, so
        # there a param is held to 2 lr (tests/test_torch_lm_substrate.py).
        new_card, new_cpu = lm_leaves(got["step"][0]), lm_leaves(want["step"][0])
        g_cpu = lm_leaves(want["grads"])
        step_err = 0.0
        for k, b in new_cpu.items():
            a = new_card[k].cpu()
            firm = g_cpu[k].abs() >= 1e-6
            d = (a - b).abs()
            step_err = max(step_err, float(d.max()))
            if not (torch.allclose(a[firm], b[firm], rtol=RTOL, atol=ATOL)
                    and float(d.max()) <= 2 * 3e-4):
                fail(f"9d {name}: the train step's {k} differs card vs CPU")
        errs["train step"] = step_err
        if abs(float(got["step"][1]) - float(want["step"][1])) > ATOL + RTOL * abs(
                float(want["step"][1])):
            fail(f"9d {name}: the train step's loss differs card vs CPU")
        rows.append((name, errs))
        del cpu, card, got, want
    check_no_kernel_launched("9d (ten reduced archs, card vs CPU)")
    for name, errs in rows:
        print(f"9d {name}: card vs CPU max abs " + ", ".join(
            f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    torch.cuda.empty_cache()


def lm_phase(dev, smi):
    """Phase 9: serving (9a yi-6b, 9b rwkv6-1.6b) and training (9c
    granite-moe-1b-a400m) at full config, and every reduced arch card
    against CPU (9d). No kernel is on this path: every count must be 0."""
    import dataclasses

    t0 = time.perf_counter()
    cfg = serve_full("9a", dev, "yi-6b", YI6B_PARAMS, batch=4, prompt=1024, gen=32, smi=smi)
    zero_kernel_counts()
    arch_property("9a yi-6b", dev, dataclasses.replace(cfg, dtype="float32", num_layers=4))
    check_no_kernel_launched("9a (yi-6b float32 property)")
    t9a = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = serve_full("9b", dev, "rwkv6-1.6b", RWKV6_PARAMS, batch=4, prompt=512, gen=32, smi=smi)
    zero_kernel_counts()
    arch_property("9b rwkv6-1.6b", dev, dataclasses.replace(cfg, dtype="float32", num_layers=2))
    check_no_kernel_launched("9b (rwkv6-1.6b float32 property)")
    t9b = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_full(dev, smi)
    t9c = time.perf_counter() - t0
    t0 = time.perf_counter()
    archs_card_vs_cpu(dev)
    t9d = time.perf_counter() - t0
    print(f"phase 9 parts: 9a {t9a:.1f}s, 9b {t9b:.1f}s, 9c {t9c:.1f}s, 9d {t9d:.1f}s; {smi}",
          flush=True)


# -- phase 10: the mesh layer (no kernel on this path) -----------------------

GRANITE = "granite-moe-1b-a400m"
MESH_B, MESH_S = 4, 128          # 10b's global batch and sequence
SCALE_B, SCALE_S = 4, 1024       # 10c's, 9c's batch (cut only if the ranks do not fit)
SCALE_STEPS = 2
RANKS_GIB = 72.0                 # of the card's 79.6 GiB: room for five contexts and slack

# One rank of a mesh sharing the card: 10b's checks (``spec["check"]``), then
# 10c's steps at scale (``spec["scale"]``). Kernel counts are zeroed just
# before each sharded step and read just after (in this process). Rank 0
# holds 10b's results against the single-device steps on the same card and
# inputs and saves its failures; every rank saves its record.
MESH_WORKER = r"""
import dataclasses, json, sys, time
import torch
from repro_torch.launch import multiprocess as mp
rank, nproc, collectives = mp.initialize_worker(device="cuda")
import torch.distributed as dist
try:
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import make_lm_batches
    from repro_torch.kernels import flash_attn, poly_attn, wkv_chunked
    from repro_torch.kernels.cheb_attn import cheb_attn, cheb_attn_backward
    from repro_torch.launch.mesh import bind_mesh, make_debug_mesh
    from repro_torch.launch.sharding import gather_tree, map_tree, shard_tree
    from repro_torch.launch.steps import (LR, adam_init_f32, build_sharded_step,
                                          make_decode_step, make_prefill_step, make_train_step)
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out, spec = sys.argv[1], json.loads(sys.argv[2])
    dev = torch.device("cuda", torch.cuda.current_device())
    bm = bind_mesh(make_debug_mesh(*spec["mesh"]))
    D = bm.shape["data"]
    counters = (cheb_attn, cheb_attn_backward, flash_attn, poly_attn, wkv_chunked)
    rec = {"rank": rank, "collectives": collectives, "launches": {}, "fails": [], "errs": {},
           "steps": {}}

    def timed(label, fn, *args):
        # one sharded step: launch counts zeroed just before and read just
        # after, host seconds around it, the collectives' bytes in it
        for c in counters:
            c.launches = 0
        for k in bm.traffic:
            bm.traffic[k] = {"calls": 0, "bytes": 0}
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        rec["steps"][label] = {"s": time.perf_counter() - t0,
                               "traffic": {k: dict(v) for k, v in bm.traffic.items()}}
        rec["launches"][label] = {c.__name__: c.launches for c in counters}
        return res

    def batches(cfg, b, s):
        it = make_lm_batches(cfg.vocab_size, b, s, seed=0)
        return lambda: {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}

    def close(label, got, want, rtol, atol):
        worst = 0.0
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            if a is None:
                continue
            if a.shape != b.shape or a.dtype != b.dtype:
                rec["fails"].append(f"{label}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
            elif a.is_floating_point():
                worst = max(worst, float((a - b).abs().max()))
                if not torch.allclose(a, b, rtol=rtol, atol=atol):
                    rec["fails"].append(f"{label}: max abs {float((a - b).abs().max()):.3e}")
            elif not torch.equal(a, b):
                rec["fails"].append(f"{label}: integers differ")
        return worst

    if spec.get("check"):
        c = spec["check"]
        cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"), dtype="float32",
                                  num_layers=c["layers"],
                                  moe_capacity_factor=c["factor"] or get_config(
                                      "granite-moe-1b-a400m").moe_capacity_factor)
        B, S = c["batch"], c["seq"]
        params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
        batch = batches(cfg, B, S)()
        for strategy, mb in (("megatron", 1), ("zero1", 1), ("fsdp", 1), ("megatron", 2)):
            label = f"train {strategy}" + (f" microbatches {mb}" if mb > 1 else "")
            fn, _, in_sh, out_sh = build_sharded_step(cfg, InputShape("t", S, B, "train"), bm,
                                                      strategy, microbatches=mb)
            opt = adam_init_f32(params)
            p, o, loss = timed(label, fn, shard_tree(params, in_sh[0]),
                               shard_tree(opt, in_sh[1]), shard_tree(batch, in_sh[2]))
            p = gather_tree(p, out_sh[0])
            if rank == 0:
                # as many microbatches as the sharded step routes the MoE in
                split = mb * (D if strategy != "fsdp" else 1)
                wp, wo, wloss = make_train_step(cfg, microbatches=split)(params, opt, batch)
                rel = abs(float(loss) - float(wloss)) / abs(float(wloss))
                if rel > 1e-5:
                    rec["fails"].append(f"{label}: loss {float(loss)!r} vs {float(wloss)!r}")
                worst = 0.0
                for a, b, m in zip(tree_leaves(p), tree_leaves(wp), tree_leaves(wo.mu)):
                    firm = 10 * m.abs() >= 1e-6          # mu = (1 - b1) g after one step
                    d = (a - b).abs()
                    worst = max(worst, float(d[firm].max()) if bool(firm.any()) else 0.0)
                    if not torch.allclose(a[firm], b[firm], rtol=1e-5, atol=1e-5 * LR) \
                            or float(d.max()) > 2 * LR:
                        rec["fails"].append(f"{label}: params beyond PR 20's rule")
                rec["errs"][label] = {"loss": float(loss), "single_device_loss": float(wloss),
                                      "loss_rel": rel, "params_firm_max_abs": worst,
                                      "single_device_microbatches": split}
                del wp, wo
            del p, o, opt
            torch.cuda.empty_cache()
        pb = {"tokens": batch["tokens"]}
        fn, _, in_sh, out_sh = build_sharded_step(cfg, InputShape("p", S, B, "prefill"), bm)
        logits, cache = timed("prefill megatron", fn, shard_tree(params, in_sh[0]),
                              shard_tree(pb, in_sh[1]))
        cache = gather_tree(cache, out_sh[1])
        if rank == 0:
            wl, wc = make_prefill_step(cfg, S)(params, pb)
            rec["errs"]["prefill megatron"] = {
                "logits_max_abs": close("prefill logits", logits, wl, 1e-4, 1e-5),
                "cache_max_abs": close("prefill cache", cache, wc, 1e-4, 1e-5)}
        n_cache = S + 8
        fn, _, in_sh, out_sh = build_sharded_step(cfg, InputShape("d", n_cache, B, "decode"), bm)
        _, cache = make_prefill_step(cfg, n_cache)(params, pb)
        tok = batch["tokens"][:, -1:]
        logits, new = timed("decode megatron", fn, shard_tree(params, in_sh[0]),
                            shard_tree(cache, in_sh[1]), shard_tree(tok, in_sh[2]))
        logits, new = gather_tree(logits, out_sh[0]), gather_tree(new, out_sh[1])
        if rank == 0:
            wl, wc = make_decode_step(cfg)(params, cache, tok)
            rec["errs"]["decode megatron"] = {
                "logits_max_abs": close("decode logits", logits, wl, 1e-4, 1e-5),
                "cache_max_abs": close("decode cache", new, wc, 1e-4, 1e-5)}
        del params, cache, logits, new
        torch.cuda.empty_cache()

    if spec.get("scale"):
        c = spec["scale"]
        cfg = get_config("granite-moe-1b-a400m")
        B, S = c["batch"], c["seq"]
        fn, args, in_sh, out_sh = build_sharded_step(cfg, InputShape("t", S, B, "train"), bm)
        full = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
        params = map_tree(lambda x: x.clone(), shard_tree(full, in_sh[0]))
        del full
        opt = map_tree(lambda m, sh: torch.zeros(bm.shard(m, sh.spec).shape, dtype=m.dtype,
                                                 device=dev), args[1], in_sh[1])
        torch.cuda.empty_cache()
        nxt = batches(cfg, B, S)
        losses = []
        for i in range(c["steps"]):
            batch = shard_tree(nxt(), in_sh[2])
            torch.cuda.reset_peak_memory_stats()
            params, opt, loss = timed(f"scale step {i}", fn, params, opt, batch)
            rec["steps"][f"scale step {i}"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            losses.append(float(loss))
        rec["scale"] = {"seq": S, "batch": B, "losses": losses,
                        "dtypes": sorted({str(t.dtype) for t in tree_leaves(params)})}
    torch.save(rec, f"{out}/rank{rank}.pt")
    print(f"rank {rank}: " + json.dumps({k: rec[k] for k in ("rank", "collectives", "steps",
                                                               "fails")}), flush=True)
finally:
    if dist.is_initialized():
        dist.destroy_process_group()
"""


def run_mesh(label, mesh, spec):
    """``MESH_WORKER`` on ``mesh`` (data, model): one process a rank, all on
    this card through ``launch``. Fails unless every rank exits 0; returns
    the ranks' records and the wall seconds with start-up."""
    import tempfile

    from repro_torch.launch import multiprocess as mp

    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(HERE, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    n = mesh[0] * mesh[1]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        code = mp.launch([sys.executable, "-c", MESH_WORKER, tmp,
                          json.dumps({"mesh": list(mesh), **spec})],
                         processes=n, devices_per_process=1, timeout=400, env=env)
        wall = time.perf_counter() - t0
        if code != 0:
            fail(f"{label}: a rank exited {code}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(n)]
    rule = mp.collectives_for("cuda", n)
    for r in ranks:
        if r["collectives"] != rule:
            fail(f"{label}: rank {r['rank']} joined with {r['collectives']}, not {rule}")
        for part, got in r["launches"].items():
            if any(got.values()):
                fail(f"{label} {part}: rank {r['rank']} launched a kernel: {got}")
    print(f"{label}: {n} ranks on {torch.cuda.device_count()} card(s), collectives {rule}, "
          f"wall {wall:.1f} s with start-up; every kernel count 0 in every step on every rank",
          flush=True)
    return ranks, wall


def print_mesh_checks(label, ranks):
    r0 = ranks[0]
    for part, errs in r0["errs"].items():
        secs = [round(r["steps"][part]["s"], 3) for r in ranks]
        traffic = r0["steps"][part]["traffic"]
        print(f"{label} {part}: {errs}; s per rank {secs}; rank 0 collectives {traffic}",
              flush=True)
    if r0["fails"]:
        fail(f"{label}: the sharded steps disagree with the single-device ones: "
             f"{r0['fails'][:8]}")


def reckon_scale_gib(cfg, batch, seq, mesh) -> dict:
    """10c's peak bytes on one rank of ``mesh`` (megatron, tensor parallel),
    reckoned from the placements before the run, float32 after step 1: the
    larger of the backward's end (the param and moment blocks, the leaves
    gathered under ``launch.steps.tp_gathers``' rule, the grads of the blocks
    and leaves the rank computes with, and the largest activations: its
    vocab block of the logits, their exps and their grad, the remat stash,
    one layer's MoE capacity buffers for the rank's experts) and the
    update's end (old and new param and moment blocks; the update frees
    each grad as it goes)."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.dryrun import per_device_bytes
    from repro_torch.launch.mesh import Mesh, spec_axes
    from repro_torch.launch.steps import ADAM_CHUNK_BYTES, build_sharded_step

    m = Mesh(("data", "model"), mesh)
    fn, args, in_sh, out_sh = build_sharded_step(cfg, InputShape("t", seq, batch, "train"), m)
    state = per_device_bytes(fn.out_specs[:2], out_sh[:2])       # float32 params + moments
    used = gathered = 0
    for x, sh, kept in zip(tree_leaves(args[0]), tree_leaves(in_sh[0]), fn.kept):
        whole = 4 * x.numel()
        split = int(np.prod([m.shape[a] for d in spec_axes(sh.spec, x.ndim) for a in d]))
        used += whole // split if kept else whole
        gathered += 0 if kept else whole
    rows = batch // mesh[0] * seq
    C = int(-(-rows * cfg.experts_per_token // cfg.num_experts) * cfg.moe_capacity_factor)
    act = (3 * rows * cfg.padded_vocab() // mesh[1] * 4 + cfg.num_layers * rows * cfg.d_model * 4
           + 4 * cfg.num_experts // mesh[1] * C * max(cfg.d_model, cfg.d_ff) * 4)
    backward = state + gathered + used + act
    # the update's temporaries: a few of its slices (launch/steps.py)
    temps = 6 * ADAM_CHUNK_BYTES
    return {"state": state, "gathered": gathered, "grads": used, "activations": act,
            "backward_end": backward, "update_end": 2 * state + temps,
            "total": max(backward, 2 * state + temps)}


# 10a's records: every arch at train_4k and decode_32k and the two recurrent
# archs at prefill_32k on 16x16 megatron, and yi-6b train_4k on 2x16x16 and
# under 16x16 fsdp; each traced on the host in a worker process.
def dryrun_records():
    from repro_torch.configs import ASSIGNED_ARCHS

    return ([(a, s, False, "megatron") for a in ASSIGNED_ARCHS for s in ("train_4k", "decode_32k")]
            + [(a, "prefill_32k", False, "megatron") for a in ("rwkv6-1.6b", "hymba-1.5b")]
            + [("yi-6b", "train_4k", True, "megatron"), ("yi-6b", "train_4k", False, "fsdp")])


POOL_WORKERS = 6           # 11b's drivers, side by side
DRYRUN_WORKERS = 3         # 10a's traces, beside phases 6-9


def pool(workers=POOL_WORKERS):
    """Worker processes for the host-side parts of phases 10a and 11b (fresh
    interpreters: the card's context is not inherited)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_pool_init)


def _pool_init():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dryrun_record(arch, shape, multi_pod, strategy):
    """One 10a record, traced in a worker; the worker's kernel counts zeroed
    just before and read just after."""
    from repro_torch.launch.dryrun import run_one

    zero_kernel_counts()
    rec = run_one(arch, shape, multi_pod, strategy=strategy)
    return rec, {fn.__name__: fn.launches for fn in kernel_counters()}


def traced_collectives(rank, batch, seq, step):
    """10c's collectives on ``rank``, traced: the (2, 2) megatron train step
    of granite's full config, its params bf16 (``step`` 0) or float32 (after
    the first AdamW update)."""
    from repro_torch.analysis.program import trace_step
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import build_sharded_step

    mesh = make_debug_mesh(2, 2)
    fn, args, in_sh, _ = build_sharded_step(get_config(GRANITE),
                                            InputShape("t", seq, batch, "train"), mesh)
    if step:
        args = (fn.out_specs[0],) + tuple(args[1:])
    cost, _, _ = trace_step(fn, args, in_sh, mesh, rank)
    return {k.replace("-", "_"): {"calls": cost.collective_calls_by_kind[k],
                                  "bytes": int(cost.collective_by_kind[k])}
            for k in cost.collective_by_kind}


def scale_seq():
    """10c's sequence (cut only if the four ranks' reckoned bytes exceed
    ``RANKS_GIB``) and its reckoning."""
    from repro_torch.configs import get_config

    seq = SCALE_S
    while True:
        rk = reckon_scale_gib(get_config(GRANITE), SCALE_B, seq, (2, 2))
        if 4 * rk["total"] / 2**30 <= RANKS_GIB or seq <= 128:
            return seq, rk
        seq //= 2


def start_dryrun():
    """10a's records and 10c's traces, submitted to ``DRYRUN_WORKERS``
    processes that run on the host beside the phases before 10; phase 10
    reads them (``mesh_phase``)."""
    seq, _ = scale_seq()
    workers = pool(DRYRUN_WORKERS)
    recs = [workers.submit(dryrun_record, *r) for r in dryrun_records()]
    traces = {(r, i): workers.submit(traced_collectives, r, SCALE_B, seq, i)
              for i in range(SCALE_STEPS) for r in range(4)}
    return workers, recs, traces, time.perf_counter()


def mesh_phase(smi, dryrun):
    """Phase 10: the mesh layer (see the module docstring); ``dryrun`` is
    what ``start_dryrun`` returned."""
    from repro_torch.analysis.report import roofline_table
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.dryrun import per_device_bytes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_sharded_step

    cfg = get_config(GRANITE)
    seq, rk = scale_seq()

    # -- 10a: the dry-run, each record's program traced ---------------------
    t0 = time.perf_counter()
    zero_kernel_counts()
    workers, recs, traces, started = dryrun
    recs = [f.result() for f in recs]
    traces = {k: f.result() for k, f in traces.items()}
    workers.shutdown()
    check_no_kernel_launched("10a (dry-run, this process)")
    launched = [(r["arch"], r["shape"], n) for r, n in recs if any(n.values())]
    if launched:
        fail(f"10a: a record's worker launched a kernel: {launched[:4]}")
    recs = [r for r, _ in recs]
    bad = [(r["arch"], r["shape"], r["mesh"], r.get("error")) for r in recs if r["status"] != "ok"]
    if bad:
        fail(f"10a: records not ok: {bad[:4]}")
    t10a = time.perf_counter() - t0
    shape = INPUT_SHAPES["train_4k"]
    dbrx = {}
    for s in ("megatron", "zero1", "fsdp"):
        fn, args, in_sh, _ = build_sharded_step(get_config("dbrx-132b"), shape,
                                                make_production_mesh(), s)
        dbrx[s] = per_device_bytes(args, in_sh)
    print(f"10a dry-run: {len(recs)} records ok, each program traced ({len(recs) - 2} on 16x16 "
          f"megatron, yi-6b train_4k on 2x16x16 and under 16x16 fsdp; {DRYRUN_WORKERS} worker "
          f"processes beside phases 6-9, every worker's kernel counts 0): "
          f"{sum(r['total_s'] for r in recs):.1f} s of tracing, all in hand "
          f"{t0 + t10a - started:.1f} s after their submission, {t10a:.1f} s waited in phase 10; "
          "trace seconds " + ", ".join(f"{r['arch']} {r['shape']} {r['mesh']} {r['strategy']} "
                                       f"{r['total_s']}" for r in recs), flush=True)
    print("10a dbrx-132b train_4k on 16x16, per-device argument bytes: " + ", ".join(
        f"{s} {b:,} ({b / 2**30:.2f} GiB)" for s, b in dbrx.items()), flush=True)
    for r in recs:
        c, m = r["hlo_cost"], r["memory_analysis"]
        print(f"10a {r['arch']} {r['shape']} {r['mesh']} {r['strategy']}: flops "
              f"{c['flops']:.4e} (loop bodies once {c['flops_unscaled']:.4e}), gathered "
              f"{c['collective_by_kind'].get('all-gather', 0):,.0f} B (param leaves "
              f"{r['gathered_leaves']}), traffic "
              f"{c['traffic_bytes']:.4e} B, collectives {c['collective_by_kind']} calls "
              f"{c['collective_calls_by_kind']}, transcendentals {c['transcendentals']:.4e}, "
              f"temp {m['temp_size_in_bytes'] / 2**30:.2f} GiB, useful flops ratio "
              f"{r['useful_flops_ratio']:.4f}, bottleneck {r['roofline']['bottleneck']}",
              flush=True)
    print("10a roofline, 16x16 megatron (H100 constants; the traced programs' flops and "
          "collectives):", flush=True)
    print(roofline_table(sorted((r for r in recs if r["mesh"] == "16x16"
                                 and r["strategy"] == "megatron"),
                                key=lambda r: (r["arch"], r["shape"]))), flush=True)

    print(f"10c reckoning, {GRANITE} full config, (2, 2) megatron, batch {SCALE_B} x seq {seq}: "
          "per rank " + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in rk.items())
          + f"; four ranks {4 * rk['total'] / 2**30:.2f} GiB of {RANKS_GIB} GiB"
          + ("" if seq == SCALE_S else f" (sequence cut from {SCALE_S} to {seq} to fit)"),
          flush=True)
    if 4 * rk["total"] / 2**30 > RANKS_GIB:
        fail("10c: four ranks do not fit on the card even at sequence 128")

    # -- 10b + 10c on a (2, 2) mesh, 10b on a (1, 2) mesh --------------------
    t0 = time.perf_counter()
    check = {"layers": 4, "batch": MESH_B, "seq": MESH_S}
    ranks, _ = run_mesh("10b+10c (2, 2)", (2, 2), {
        "check": {**check, "factor": cfg.num_experts},
        "scale": {"batch": SCALE_B, "seq": seq, "steps": SCALE_STEPS}})
    print_mesh_checks(f"10b (2, 2) {GRANITE} float32, 4 layers, capacity factor "
                      f"{cfg.num_experts}, batch {MESH_B} x {MESH_S}:", ranks)
    for i in range(SCALE_STEPS):
        part = f"scale step {i}"
        peaks = [round(r["steps"][part]["peak_gib"], 2) for r in ranks]
        print(f"10c {GRANITE} bf16, 24 layers, (2, 2) megatron, batch {SCALE_B} x {seq}, step {i}"
              f": s per rank {[round(r['steps'][part]['s'], 3) for r in ranks]}, peak GiB per "
              f"rank (max_memory_allocated) {peaks} against {rk['total'] / 2**30:.2f} reckoned "
              f"(backward's end {rk['backward_end'] / 2**30:.2f}, update's end "
              f"{rk['update_end'] / 2**30:.2f}), collectives per "
              f"rank {[r['steps'][part]['traffic'] for r in ranks]}; {smi}", flush=True)
        for r in ranks:
            measured = {k: v for k, v in r["steps"][part]["traffic"].items() if v["calls"]}
            if measured != traces[(r["rank"], i)]:
                fail(f"10c step {i}: rank {r['rank']}'s collectives {measured} differ from its "
                     f"trace {traces[(r['rank'], i)]}")
    print(f"10c: every rank's collectives in both steps equal its traced program's (calls and "
          f"bytes by kind): {[traces[(r, 0)] for r in range(4)]} (step 0), "
          f"{[traces[(r, 1)] for r in range(4)]} (step 1)", flush=True)
    sc = ranks[0]["scale"]
    print(f"10c losses {sc['losses']}, param dtypes after {SCALE_STEPS} steps {sc['dtypes']}",
          flush=True)
    if not all(np.isfinite(sc["losses"])) or abs(sc["losses"][0] - np.log(cfg.padded_vocab())) \
            >= 1.5 or sc["dtypes"] != ["torch.float32"]:
        fail("10c: the losses are not finite, the first is not near log(vocab), or the params "
             "are not float32 after the first step")
    t22 = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks, _ = run_mesh("10b (1, 2)", (1, 2), {"check": {**check, "factor": None}})
    print_mesh_checks(f"10b (1, 2) {GRANITE} float32, 4 layers, capacity factor "
                      f"{cfg.moe_capacity_factor}, batch {MESH_B} x {MESH_S}:", ranks)
    t12 = time.perf_counter() - t0
    print(f"phase 10 parts: 10a {t10a:.1f}s, 10b+10c (2, 2) {t22:.1f}s, 10b (1, 2) {t12:.1f}s; "
          f"{smi}", flush=True)


# -- phase 11: the reference API and the paper's experiment drivers ---------
# Plain PyTorch (the dense forms, the moments) and the drivers' Trainer runs
# through the ``direct``, ``exact`` and ``vector`` engines and GCN: no kernel
# is on this path, so every count, zeroed just before each part, reads 0
# just after it.

PAPER_RTOL, PAPER_ATOL = 1e-4, 1e-6   # the theorem drivers' float32 maxima, card vs CPU
# The discovered modules that are system benchmarks, not paper drivers (phase 12).
SYSTEM_BENCHES = {"fed_scale_bench", "graph_bench", "kernel_bench", "privacy_audit",
                  "privacy_tradeoff", "serve_bench"}
POWER_RTOL = 1e-3                     # err_power at high degree (monomial cancellation)
DENSE_TOL = 1e-5                      # tests/test_gat.py:33, tests/test_bucketed_kernel.py:108
MOMENT_RTOL, MOMENT_ATOL = 1e-5, 1e-6


def rows_close(label, got, want):
    """The theorem drivers' rows on the card against the CPU's: keys and
    order equal, flags and degrees equal, ``err_power`` finite alike and at
    rtol 1e-3 where finite, every other value at rtol 1e-4 / atol 1e-6."""
    worst = 0.0
    if [list(r) for r in got] != [list(r) for r in want]:
        fail(f"{label}: the card's rows have other keys than the CPU's")
    for a, b in zip(got, want):
        for k, w in b.items():
            v = a[k]
            if isinstance(w, bool) or k == "degree":
                ok = v == w
            elif k == "err_power":
                ok = np.isfinite(v) == np.isfinite(w) and (
                    not np.isfinite(w) or abs(v - w) <= POWER_RTOL * abs(w))
            else:
                ok = abs(v - w) <= PAPER_ATOL + PAPER_RTOL * abs(w)
            if isinstance(w, float) and np.isfinite(w) and np.isfinite(v):
                worst = max(worst, abs(v - w))
            if not ok:
                fail(f"{label}: {k} on the card {v!r} against the CPU's {w!r}")
    return worst


def paper_phase(dev, smi):
    """Phase 11: the reference API the port took over last (11a) and the
    eight paper drivers of ``benchmarks_torch`` at their ``fast`` sweeps
    (11b)."""
    from benchmarks_torch.run import discover_benches
    from repro_torch.core import (FedGATConfig, gat_forward, gcn_forward, init_gcn_params,
                                  init_params, moments_direct, normalized_adjacency)
    from repro_torch.core.fedgat_model import graph_tensors
    from repro_torch.core.gcn import gcn_forward_nbr, normalized_nbr_coeffs
    from repro_torch.core.poly_attention import edge_scores, head_projections
    from repro_torch.graphs import (DenseAdjacencyError, dense_view_count, make_cora_like,
                                    make_sbm)

    # -- 11a: the dense forms and the moments on the card ------------------
    t0 = time.perf_counter()
    zero_kernel_counts()
    try:
        make_sbm("sbm_100k", seed=SEED).adj
        fail("11a: sbm_100k's dense view did not raise DenseAdjacencyError")
    except DenseAdjacencyError as err:
        print(f"11a sbm_100k dense view refused: {err}", flush=True)
    g = make_cora_like("cora_like", seed=SEED)
    cfg = FedGATConfig()
    params = init_params(torch.Generator().manual_seed(SEED), g.feature_dim, g.num_classes,
                         cfg, device=dev)
    h, idx, mask = graph_tensors(g, dev)
    adj = g.adj
    with torch.no_grad():
        dense = gat_forward(params, h, torch.as_tensor(adj, device=dev))
        nbr = gat_forward(params, h, None, use_nbr=True, nbr_idx=idx, nbr_mask=mask)
        gparams = init_gcn_params(torch.Generator().manual_seed(SEED), g.feature_dim, 16,
                                  g.num_classes, device=dev)
        gcn_dense = gcn_forward(gparams, h, torch.as_tensor(normalized_adjacency(adj),
                                                            device=dev))
        coef = torch.as_tensor(normalized_nbr_coeffs(g.nbr_idx, g.nbr_mask), device=dev)
        gcn_nbr = gcn_forward_nbr(gparams, h, idx, coef)
        b1, b2 = head_projections(params[0])
        x = edge_scores(b1, b2, h, idx)
        E, F = moments_direct(x, h[idx], mask, cfg.degree)
        E_cpu, F_cpu = moments_direct(x.cpu(), h[idx].cpu(), mask.cpu(), cfg.degree)
    check_no_kernel_launched("11a (dense forms, moments)")
    errs = {
        "gat dense vs nbr": (dense, nbr, DENSE_TOL, DENSE_TOL),
        "gcn dense vs nbr": (gcn_dense, gcn_nbr, 0.0, DENSE_TOL),
        "moments E card vs CPU": (E.cpu(), E_cpu, MOMENT_RTOL, MOMENT_ATOL),
        "moments F card vs CPU": (F.cpu(), F_cpu, MOMENT_RTOL, MOMENT_ATOL),
    }
    for label, (got, want, rtol, atol) in errs.items():
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and torch.allclose(got, want, rtol=rtol, atol=atol)
        print(f"11a cora_like N={g.num_nodes} B={g.max_degree} {label}: max_abs_err {err:.3e} "
              f"allclose(rtol={rtol},atol={atol})={ok}", flush=True)
        if not ok:
            fail(f"11a: {label} disagree")
    if dense_view_count() != 1:
        fail(f"11a: {dense_view_count()} dense views (want the one of cora_like)")
    t11a = time.perf_counter() - t0

    # -- 11b: the paper drivers, fast sweeps, on the card -------------------
    found = discover_benches()
    benches = [(name, mod) for name, mod in found if name not in SYSTEM_BENCHES]
    names = [name for name, _ in benches]
    print(f"11b drivers discovered: {names} (and phase 12's {sorted(SYSTEM_BENCHES)})",
          flush=True)
    if len(names) != 8 or len(found) != 8 + len(SYSTEM_BENCHES):
        fail(f"11b: discovered {len(found)} modules, {len(names)} drivers; want 14 and 8")
    t0 = time.perf_counter()
    total_steps, seconds = 0, {}
    with pool() as workers:                 # the drivers are host-bound: run side by side
        runs = {name: workers.submit(paper_driver, name, str(dev)) for name in names}
        for name, mod in benches:
            rows, n_steps, nodes, seconds[name], launches, derived = runs[name].result()
            want = {k: 0 for k in launches}
            want["nbr_gather_backward"] = nodes
            print(f"11b {name}: {len(rows)} rows, {n_steps} local steps, {seconds[name]:.2f} s "
                  f"(in a worker, beside {min(POOL_WORKERS, len(names)) - 1} others); "
                  f"{derived}; launches {launches} (want {want}: plain PyTorch but one gather "
                  f"backward a gradient node of the gathers); {smi}", flush=True)
            if launches != want:
                fail(f"11b {name}: the kernel launch counts differ from the reckoning")
            total_steps += n_steps
            accs = [r[k] for r in rows for k in ("acc", "std") if k in r]
            if not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
                fail(f"11b {name}: an accuracy is not finite or not in [0, 1]")
            if name in ("thm2_cheb_error", "fig3_comm"):
                host = mod.run(fast=True, device="cpu")
                if rows != host:
                    fail(f"11b {name}: the card's rows differ from the CPU's")
                print(f"11b {name}: rows equal to the CPU's", flush=True)
            elif name in ("thm35_error_prop", "stability_basis"):
                worst = rows_close(f"11b {name}", rows, mod.run(fast=True, device="cpu"))
                print(f"11b {name}: card vs CPU max abs diff {worst:.3e} (rtol {PAPER_RTOL}, "
                      f"atol {PAPER_ATOL}; err_power rtol {POWER_RTOL})", flush=True)
    print(f"phase 11 parts: 11a {t11a:.1f}s, 11b {time.perf_counter() - t0:.1f}s "
          f"({total_steps} local steps; " + ", ".join(f"{k} {v:.1f}s" for k, v in seconds.items())
          + f"); {smi}", flush=True)


def paper_driver(name, device):
    """One paper driver's ``fast`` sweep on ``device``, in a worker process:
    its rows, local steps (calls of the trainer's ``grad_of``), the gathers'
    autograd nodes, seconds, kernel launches (zeroed just before, read just
    after) and derived line."""
    import importlib

    from repro_torch._device import sync

    mod = importlib.import_module(f"benchmarks_torch.{name}")
    dev = torch.device(device)
    zero_kernel_counts()
    with counted_steps() as steps, counted_gather_nodes() as nodes:
        t0 = time.perf_counter()
        rows = mod.run(fast=True, device=dev)
        sync(dev)
        seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in kernel_counters()}
    return rows, steps.n, nodes.n, seconds, launches, mod.derived(rows)


# -- phase 12: the system benchmarks, the two smokes and the examples ---------
# Each module runs in a process of its own (``MODULE_WORKER``): its launch
# counts, zeroed just before its call and read just after, are exact for
# that call alone. A process is started while the module before it runs
# (torch's import and the CUDA context take ~8 s) and waits for "go" on its
# standard input; it exits at end of input, so none outlives the smoke.

MODULE_WORKER = r"""
import importlib, json, os, sys, time
t_start = time.perf_counter()
sys.path[:0] = [os.path.join(sys.argv[1], "src"), sys.argv[1]]
import numpy as np
import torch
import repro_torch.federated, repro_torch.models, repro_torch.privacy.attacks, repro_torch.serving
from repro_torch.graphs import dense_view_count
from repro_torch.kernels import flash_attn, poly_attn, wkv_chunked
from repro_torch.kernels.cheb_attn import cheb_attn, cheb_attn_backward
from repro_torch.kernels.nbr_gather import NbrGather, nbr_gather_backward
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
spec = json.loads(sys.argv[2])
device = spec.get("device", "cuda")
sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
torch.zeros(1, device=device)
sync()
mod = importlib.import_module(spec["module"])
startup = time.perf_counter() - t_start
if sys.stdin.readline().strip() != "go":
    sys.exit(0)
recorded = {}
for name in spec.get("record", []):
    def recorder(*args, _fn=getattr(mod, name), _name=name, **kwargs):
        out = _fn(*args, **kwargs)
        recorded[_name] = ({k: np.asarray(v).tolist() for k, v in out.items()}
                           if isinstance(out, dict) else out)
        return out
    setattr(mod, name, recorder)
counters = (cheb_attn, cheb_attn_backward, flash_attn, nbr_gather_backward, poly_attn,
            wkv_chunked)
for c in counters:
    c.launches = 0
gather_nodes = [0]                # the gathers' autograd nodes: one backward each
def counted_apply(*args, _apply=NbrGather.apply):
    gather_nodes[0] += 1
    return _apply(*args)
NbrGather.apply = counted_apply
t0 = time.perf_counter()
if "argv" in spec:
    rows, derived = None, None
    rc = mod.main(spec["argv"] + ([] if device == "cuda" else ["--device", device]))
else:
    rows = mod.run(fast=True, device=device, **spec.get("kwargs", {}))
    derived, rc = mod.derived(rows), 0
sync()
seconds = time.perf_counter() - t0
launches = {c.__name__: c.launches for c in counters}
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro", "benchmarks"))
print("RESULT " + json.dumps({"rc": rc, "seconds": seconds, "startup": startup,
                              "launches": launches, "gather_nodes": gather_nodes[0],
                              "rows": rows, "derived": derived,
                              "recorded": recorded, "loaded": loaded,
                              "dense_views": dense_view_count()}), flush=True)
"""

SERVING_TOLS = {"direct": (0.0, 0.0), "kernel": (RTOL, ATOL), "vector": (RTOL, ATOL),
                "matrix": MATRIX_TOL}
MASKED_TOL = 1e-5             # one masked round against the plain one (tests/test_privacy.py)
E2E_ROUNDS = 20


def start_module(spec):
    """A worker process for ``spec``, started now and waiting for "go"."""
    return subprocess.Popen([sys.executable, "-c", MODULE_WORKER, HERE, json.dumps(spec)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=HERE)


def finish_module(label, proc, want, smi):
    """Let ``proc`` run its module; fails unless it returns 0 (or None), loads
    nothing of JAX or the reference, and launches exactly ``want`` (every
    other kernel: 0). Returns its result record."""
    t0 = time.perf_counter()
    try:
        out, err = proc.communicate("go\n", timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail(f"12 {label}: no result within 600 s")
    wall = time.perf_counter() - t0
    lines = out.splitlines()
    for line in lines:
        if not line.startswith("RESULT "):
            print(f"  {label}| {line}", flush=True)
    results = [line for line in lines if line.startswith("RESULT ")]
    if proc.returncode != 0 or not results:
        print(err[-4000:], file=sys.stderr)
        fail(f"12 {label}: the module's process exited {proc.returncode}")
    res = json.loads(results[-1][len("RESULT "):])
    want_all = {"cheb_attn": 0, "cheb_attn_backward": 0, "flash_attn": 0,
                "nbr_gather_backward": res["gather_nodes"], "poly_attn": 0, "wkv_chunked": 0,
                **want}
    print(f"12 {label}: {res['seconds']:.2f} s in its call ({wall:.2f} s from go to exit; "
          f"its process's start-up {res['startup']:.2f} s); launches "
          f"{res['launches']} (want {want_all}); derived: {res['derived']}; {smi}", flush=True)
    if res["rc"] not in (0, None):        # the large-graph smoke's main returns None
        fail(f"12 {label}: returned {res['rc']}")
    if res["loaded"]:
        fail(f"12 {label}: loaded {res['loaded']}")
    if res["launches"] != want_all:
        fail(f"12 {label}: the kernel launch counts differ from the reckoning")
    return res


def run_modules(modules, smi, alone=()):
    """Each (label, spec, want) of ``modules`` in turn, each in its own
    process, the next two started while the current one runs; no process
    starts while a module in ``alone`` (one whose timings are gated) runs.
    Returns {label: result record}."""
    procs = {}

    def ensure(j):
        if j not in procs:
            procs[j] = start_module(modules[j][1])

    results = {}
    for i, (label, spec, want) in enumerate(modules):
        ensure(i)
        if label not in alone:
            for j in range(i + 1, min(i + 3, len(modules))):
                if any(modules[k][0] in alone for k in range(i + 1, j)):
                    break
                ensure(j)
        results[label] = finish_module(label, procs.pop(i), want, smi)
    return results


def benches_phase(smi):
    """Phase 12: the system benchmarks at ``--fast``, the large-graph and
    telemetry smokes, and the four examples, each through its own entry
    point on the card. Returns each kernel's launches by path
    ("benches", "examples"), summed over the modules' own counts."""
    import tempfile

    from benchmarks_torch import graph_bench, kernel_bench, serve_bench
    from repro_torch.graphs import make_sbm
    from repro_torch.kernels.ops import degree_bucket_plan

    t_phase = time.perf_counter()
    # Launches reckoned from the code: kernel_bench, one warm-up and REPEATS
    # timed calls a kernel a row; graph_bench, each size's repeats x (one flat
    # launch + one a bucket); serve_bench, one forward a client (a pack miss)
    # of the kernel server; the large-graph smoke, one flat layer; the
    # engines example, the kernel engine's one forward; all else 0.
    want_kernel = {k: v for k, v in kernel_bench.expected_launches(True).items() if v}
    want_graph = sum(reps * (1 + len(degree_bucket_plan(make_sbm(preset, seed=0).nbr_mask)))
                     for preset, _, reps in graph_bench.sizes_for(True))
    want_serve = sum(serve_bench.sweep(True)[1])     # every client is among the queries
    with tempfile.TemporaryDirectory() as tmp:
        modules = [
            ("kernel_bench", {"module": "benchmarks_torch.kernel_bench"}, want_kernel),
            ("graph_bench", {"module": "benchmarks_torch.graph_bench"},
             {"cheb_attn": want_graph}),
            ("serve_bench", {"module": "benchmarks_torch.serve_bench"},
             {"cheb_attn": want_serve}),
            ("fed_scale_bench", {"module": "benchmarks_torch.fed_scale_bench"}, {}),
            ("privacy_audit", {"module": "benchmarks_torch.privacy_audit"}, {}),
            ("privacy_tradeoff", {"module": "benchmarks_torch.privacy_tradeoff",
                                  "kwargs": {"backend": "vmap"}}, {}),
            ("large_graph_smoke", {"module": "benchmarks_torch.large_graph_smoke",
                                   "argv": []}, {"cheb_attn": 1}),
            ("telemetry_smoke", {"module": "benchmarks_torch.telemetry_smoke",
                                 "argv": ["--out", os.path.join(tmp, "telemetry")]}, {}),
            ("quickstart", {"module": "examples_torch.quickstart", "argv": []}, {}),
            ("e2e_federated_training", {
                "module": "examples_torch.e2e_federated_training",
                "argv": ["--rounds", str(E2E_ROUNDS), "--ckpt", os.path.join(tmp, "ckpt.npz")]},
             {}),
            ("engines_and_privacy", {"module": "examples_torch.engines_and_privacy",
                                     "argv": [], "record": ["engine_logits",
                                                            "masked_round_drift"]},
             {"cheb_attn": 1}),
            ("lm_train_smoke", {"module": "examples_torch.lm_train_smoke",
                                "argv": ["--arch", "granite-moe-1b-a400m"]}, {}),
        ]
        res = run_modules(modules, smi, alone={"telemetry_smoke"})

    tols = {"cheb_attn": (RTOL, ATOL), "cheb_attn_layer": (RTOL, ATOL),
            "cheb_attn_heads": (RTOL, ATOL), "flash_attn": FLASH_TOL, "poly_attn": POLY_TOL}
    if kernel_bench.TOLERANCES != tols:
        fail(f"12 kernel_bench: tolerances {kernel_bench.TOLERANCES} are not phase 5's {tols}")
    for row in res["kernel_bench"]["rows"]:
        times = {k: round(v, 1) for k, v in row.items() if k.startswith("us_")}
        print(f"12 kernel_bench {row['kernel']} {row['shape']}: {times} us (best of "
              f"{kernel_bench.REPEATS}); max_err {row['max_err']:.3e}, {row['err_over_tol']:.3f} "
              f"of (rtol, atol) {tols[row['kernel']]}; plan {row.get('launch_plan', '-')}",
              flush=True)
        if not row["err_over_tol"] <= 1.0:
            fail(f"12 kernel_bench {row['kernel']}: the kernel disagrees with its plain version")
    for label in ("graph_bench", "large_graph_smoke"):
        if res[label]["dense_views"] != 0:
            fail(f"12 {label}: {res[label]['dense_views']} dense views")
    for row in res["serve_bench"]["rows"]:
        if row["engine"] != row["engine_requested"] or row["cache_misses"] != row["clients"]:
            fail(f"12 serve_bench: row {row} took another engine or missed another count")
    if serve_bench.kernel_launches(res["serve_bench"]["rows"]) != want_serve:
        fail("12 serve_bench: launches differ from the kernel server's pack misses")
    for name in ("graph_bench", "serve_bench", "fed_scale_bench", "privacy_audit",
                 "privacy_tradeoff"):
        for row in res[name]["rows"]:
            print(f"12 {name}: " + json.dumps(row), flush=True)
        accs = [r[k] for r in res[name]["rows"] for k in ("acc", "final_test") if k in r]
        if not all(np.isfinite(a) and 0.0 <= a <= 1.0 for a in accs):
            fail(f"12 {name}: an accuracy is not finite or not in [0, 1]")

    recorded = res["engines_and_privacy"]["recorded"]
    logits = {k: np.asarray(v) for k, v in recorded["engine_logits"].items()}
    for engine, (rtol, atol) in SERVING_TOLS.items():
        ok = np.isfinite(logits[engine]).all() and np.allclose(
            logits[engine], logits["direct"], rtol=rtol, atol=atol)
        err = float(np.abs(logits[engine] - logits["direct"]).max())
        print(f"12 engines_and_privacy {engine} vs direct: max_abs_err {err:.3e} "
              f"allclose(rtol={rtol},atol={atol})={ok}", flush=True)
        if not ok:
            fail(f"12 engines_and_privacy: the {engine} engine disagrees with direct")
    drift = recorded["masked_round_drift"]
    print(f"12 engines_and_privacy masked vs plain round: max_abs_diff {drift:.3e} "
          f"(want <= {MASKED_TOL})", flush=True)
    if not drift <= MASKED_TOL:
        fail("12 engines_and_privacy: the masked round differs from the plain one")

    by_path = {"benches": Counter(), "examples": Counter()}
    for label, spec, _ in modules:
        path = "examples" if spec["module"].startswith("examples_torch.") else "benches"
        by_path[path].update(res[label]["launches"])
    benches, examples = dict(by_path["benches"]), dict(by_path["examples"])
    print(f"phase 12: {time.perf_counter() - t_phase:.1f}s; calls "
          + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in res.items())
          + f"; launches benches {benches}, examples {examples}; {smi}", flush=True)
    return benches, examples


def benches_phase_process(smi):
    """:func:`benches_phase` in a process of its own, which holds no CUDA
    context and no graph. ``large_graph_smoke`` and ``fed_scale_bench``
    read their peak RSS as ``VmHWM``, which starts anew at ``exec``, where
    ``/proc/self/status`` has it. Under a kernel whose ``/proc/self/status``
    has no ``VmHWM`` (gVisor's, for one) they read ``ru_maxrss``, which
    starts a child at the peak of the process that launched it: this one
    holds gigabytes by phase 12, which the large-graph smoke's RSS budget
    would count as its own. The phase prints to this process's standard
    output; its launches come back through a file."""
    import tempfile

    sys.stdout.flush()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "launches.json")
        code = ("import json, sys\n"
                f"sys.path.insert(0, {HERE!r})\n"
                "import chip_smoke\n"
                "launches = chip_smoke.benches_phase(sys.argv[1])\n"
                "json.dump(launches, open(sys.argv[2], 'w'))\n")
        rc = subprocess.run([sys.executable, "-c", code, smi, out], cwd=HERE).returncode
        if rc != 0:
            fail(f"phase 12 exited {rc}")
        benches, examples = json.load(open(out))
    return benches, examples


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    from repro_torch.core import FedGATConfig, get_engine, init_params, layered_forward
    from repro_torch.core.fedgat_model import graph_tensors
    from repro_torch.graphs import (dense_view_count, make_cora_like, make_sbm,
                                    reset_dense_view_count)
    from repro_torch.federated import FederatedConfig, run_federated
    from repro_torch.federated import trainer as fed_trainer
    from repro_torch.kernels import _build
    from repro_torch.kernels.cheb_attn import cheb_attn, cheb_attn_backward
    from repro_torch.kernels.nbr_gather import nbr_gather_backward
    from repro_torch.kernels.ref import cheb_attn_bwd_ref, cheb_attn_ref
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
        print(f"  {name}: nvcc {info['seconds']:.2f}s; "
              + "; ".join(ptxas_summary(str(info["ptxas"]))), flush=True)
    for name in ("flash_attn", "poly_attn", "cheb_attn", "wkv_chunk"):
        counts = sass_mma_counts(libs[name])
        print(f"  {name} SASS tensor-core instructions: {counts}", flush=True)
        if name == "poly_attn" and not (any(k.startswith("HGMMA.") for k in counts)
                                        and "HMMA.1688.F32.TF32" in counts):
            fail("poly_attn's library lacks HGMMA (bf16) or HMMA.1688.F32.TF32 (float32)")
        if name == "wkv_chunk" and "HMMA.1688.F32.TF32" not in counts:
            fail("wkv_chunk's library lacks HMMA.1688.F32.TF32 (the fast path's products)")

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
        host_ms = wrapper_host_ms(lambda: cheb_attn(x, h_nb, mask_f, coeffs))
        fwd_load = fwd_plan(x, h_nb, mask_f)["load"]
        if fwd_load != "tma":
            fail(f"cheb_attn at the serve shape takes the {fwd_load} path, not TMA")
        print(f"cheb_attn serve shape: launch_plan {fwd_plan(x, h_nb, mask_f)}; wrapper host "
              f"time {host_ms:.4f} ms per call (host clock, no sync, median of 50) beside its "
              f"single-call median {ms_kernel:.4f} ms", flush=True)
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

    # -- phase 2b: the backward kernel against its plain version -----------
    with torch.no_grad():
        x, h_nb, mask_f = layer1_inputs(params[0], h, nbr_idx, nbr_mask)
    dout = torch.randn(x.shape[:-1] + h_nb.shape[-1:], generator=gen, device=dev)
    bwd_errs = [compare_cheb_attn_backward("train", x, h_nb, mask_f, coeffs, dout)]
    x2, m2 = x.clone(), mask_f.clone()
    m2[iso] = 0.0
    x2[:, neg] = -6.0
    m2[neg] = 1.0
    bwd_errs.append(compare_cheb_attn_backward(
        "train+isolated+negative", x2, h_nb, m2, coeffs, dout, iso=iso))
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
        ds = torch.randn(xs.shape[:-1] + (d,), generator=gen, device=dev)
        bwd_errs.append(compare_cheb_attn_backward(
            label, xs, hs, ms, coeffs, ds, iso=(5,), nan_rows=(11,)))
    dx_only = (True, False, False, False)              # what training asks for
    # Training's request takes the kernel's register path (no dh_nb, no
    # dcoeffs): dx alone against the plain backward, with the isolated and
    # negative-denominator rows.
    for label, xx, mm in (("train", x, mask_f), ("train+isolated+negative", x2, m2)):
        got = cheb_attn_backward(xx, h_nb, mm, coeffs, dout, dx_only)[0]
        want = cheb_attn_bwd_ref(xx, h_nb, mm, coeffs, dout, dx_only)[0]
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        zeros = all(bool((got[:, i] == 0).all()) for i in iso) if mm is m2 else True
        print(f"cheb_attn backward {label} (dx only): max_abs_err {err:.3e} "
              f"allclose(rtol={GRAD_RTOL},atol={GRAD_ATOL})={ok} isolated_rows_exact_zero={zeros}",
              flush=True)
        if not (ok and zeros):
            fail(f"cheb_attn backward {label} (dx only): kernel disagrees with the plain version")
        bwd_errs.append(err)
        del got, want
    del x2, m2
    ms_bwd = cuda_ms(lambda: cheb_attn_backward(x, h_nb, mask_f, coeffs, dout, dx_only))
    ms_bwd_all = cuda_ms(lambda: cheb_attn_backward(x, h_nb, mask_f, coeffs, dout), reps=5)
    # Each cotangent alone: where the all-four request's time goes.
    ms_bwd_each = {name: cuda_ms(lambda: cheb_attn_backward(
        x, h_nb, mask_f, coeffs, dout, tuple(i == j for j in range(4))), reps=5)
        for i, name in enumerate(("dx", "dh_nb", "dmask", "dcoeffs"))}
    ms_bwd_plain = cuda_ms(lambda: cheb_attn_bwd_ref(x, h_nb, mask_f, coeffs, dout, dx_only),
                           reps=5, warmup=1)
    bwd_bound_ms, bwd_bound_by, bwd_bytes = cheb_attn_bwd_bound_ms(
        x, h_nb, mask_f, coeffs, dout, dx_only)
    all_bound_ms = cheb_attn_bwd_bound_ms(x, h_nb, mask_f, coeffs, dout, (True,) * 4)[0]
    each = ", ".join(f"{k} {v:.4f}" for k, v in ms_bwd_each.items())
    print(f"cheb_attn backward train shape (dx only): kernel {ms_bwd:.4f} ms, plain "
          f"{ms_bwd_plain:.4f} ms, bound {bwd_bound_ms:.4f} ms ({bwd_bound_by}, "
          f"{bwd_bytes / 1e9:.3f} GB), {bwd_bytes / (ms_bwd * 1e-3) / 1e12:.3f} TB/s achieved; "
          f"all four cotangents {ms_bwd_all:.4f} ms (bound {all_bound_ms:.4f} ms); each alone "
          f"(ms): {each}; no single PyTorch call computes this "
          "function, so library_ms is null", flush=True)
    del x, h_nb, mask_f, dout
    torch.cuda.empty_cache()

    # -- phase 2c: the neighbour gathers' backward --------------------------
    gather_entry = nbr_gather_phase(dev)

    # -- phase 3: serving through the kernel engine ------------------------
    reset_dense_view_count()
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

    # -- phase 4: federated training through the kernel engine -------------
    fed_cfg = FederatedConfig(
        method="fedgat", num_clients=4, beta=1.0, rounds=3, local_steps=3,
        aggregator="fedavg", seed=SEED, model=FedGATConfig(engine="kernel"),
    )
    n_sel = fed_trainer.num_selected(fed_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t0 = time.perf_counter()
    res = run_federated(g, fed_cfg, device=dev)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_fwd, train_bwd = cheb_attn.launches, cheb_attn_backward.launches
    train_gather = nbr_gather_backward.launches
    want_fwd = fed_cfg.rounds * (n_sel * fed_cfg.local_steps + 1)
    want_bwd = fed_cfg.rounds * n_sel * fed_cfg.local_steps
    want_gather = GATHER_BWD_PER_STEP["kernel"] * want_bwd
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"train sbm_1m: fedgat kernel engine, {fed_cfg.num_clients} clients "
          f"({n_sel} per round), {fed_cfg.rounds} rounds x {fed_cfg.local_steps} local steps: "
          f"{res['seconds'] / fed_cfg.rounds:.3f} s per round (trainer clock), wall "
          f"{train_wall:.2f} s with set-up; launches forward {train_fwd} (want {want_fwd}), "
          f"backward {train_bwd} (want {want_bwd}), gather backward {train_gather} (want "
          f"{want_gather}); peak {peak_gib:.2f} GiB; "
          f"val {res['val_curve']} test {res['test_curve']}", flush=True)
    if (train_fwd, train_bwd, train_gather) != (want_fwd, want_bwd, want_gather):
        fail("the training path's kernel launch counts differ from the schedule's")
    if not all(bool(torch.isfinite(p).all()) for p in res["params"].parameters()):
        fail("trained params are not finite")
    phase4 = {"cfg": fed_cfg, "curves": (res["val_curve"], res["test_curve"]),
              "params": host_named(res["params"])}

    # Device time of one local step and its parts (after the counts were read).
    from repro_torch.federated.aggregation import fedavg
    from repro_torch.optim import adam_init, adam_update

    part = res["partition"]
    _, forward = fed_trainer.build_forward(fed_cfg, g, dev)
    labels = torch.as_tensor(g.labels, dtype=torch.int64, device=dev)
    tr_mask = torch.as_tensor(part.owner == 0, device=dev) & torch.as_tensor(g.train_mask, device=dev)
    loss_fn = fed_trainer.make_loss_fn(forward, labels)
    tparams = fed_trainer.param_tree(res["params"])
    grads = fed_trainer.grad_of(loss_fn, tparams, nbr_mask, tr_mask)
    opt = adam_init(tparams)
    stacked = [{k: torch.stack([v] * n_sel) for k, v in layer.items()} for layer in tparams]
    ms_step = cuda_ms(lambda: fed_trainer.grad_of(loss_fn, tparams, nbr_mask, tr_mask), reps=5)
    with torch.no_grad():
        ms_step_fwd = cuda_ms(lambda: loss_fn(tparams, nbr_mask, tr_mask), reps=5)
    ms_adam = cuda_ms(lambda: adam_update(grads, opt, tparams, fed_cfg.lr,
                                          weight_decay=fed_cfg.weight_decay), reps=10)
    ms_fedavg = cuda_ms(lambda: fedavg(stacked), reps=10)
    print(f"train step sbm_1m (device): forward+backward {ms_step:.3f} ms, of which forward "
          f"{ms_step_fwd:.3f} ms and backward {ms_step - ms_step_fwd:.3f} ms; backward kernel "
          f"{ms_bwd:.3f} ms ({100 * ms_bwd / ms_step:.2f}% of the step); adam {ms_adam:.3f} ms; "
          f"fedavg of {n_sel} clients {ms_fedavg:.3f} ms", flush=True)
    print_step_profile(lambda: fed_trainer.grad_of(loss_fn, tparams, nbr_mask, tr_mask))
    del grads, opt, stacked, forward, res
    torch.cuda.empty_cache()

    # The same training config on a small graph, on the card and on the CPU.
    tiny = make_cora_like("tiny", seed=SEED)
    on_gpu = run_federated(tiny, fed_cfg, device=dev)
    on_cpu = run_federated(tiny, fed_cfg, device="cpu")
    curves = (np.allclose(on_gpu["val_curve"], on_cpu["val_curve"], atol=1e-6)
              and np.allclose(on_gpu["test_curve"], on_cpu["test_curve"], atol=1e-6))
    perr = max(float((a.detach().cpu() - b.detach()).abs().max())
               for a, b in zip(on_gpu["params"].parameters(), on_cpu["params"].parameters()))
    pclose = all(torch.allclose(a.detach().cpu(), b.detach(), rtol=GRAD_RTOL, atol=GRAD_ATOL)
                 for a, b in zip(on_gpu["params"].parameters(), on_cpu["params"].parameters()))
    print(f"tiny training check: card vs CPU curves equal (atol 1e-6) {curves}, final params "
          f"max abs diff {perr:.3e} allclose(rtol={GRAD_RTOL},atol={GRAD_ATOL}) {pclose}; "
          f"val {on_gpu['val_curve']} test {on_gpu['test_curve']}", flush=True)
    if not (curves and pclose):
        fail("tiny: training on the card disagrees with training on the CPU")

    # A small graph served on the card against the plain path on the CPU.
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
    del on_gpu, on_cpu, tparams

    # -- phase 5: the kernel API at two zoo models' widths ----------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    api, bucket_launches, bucket_kernel_err, bucket_err, bucket_ms = kernel_api_phase(
        dev, g, params[0], coeffs, h, nbr_idx, nbr_mask)
    print(f"kernel API phase: {time.perf_counter() - t0:.1f}s")

    # -- phase 10a's traces start on the host, beside phases 6-9 -----------
    dryrun = start_dryrun()

    # -- phase 6: the pack engines (the gathers' backward alone) -----------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pack_engines_phase(dev, g, params, want_direct)
    print(f"pack engine phase: {time.perf_counter() - t0:.1f}s")

    # -- phase 7: cohort streaming and the privacy stack --------------------
    del g, params, h, nbr_idx, nbr_mask, server, batcher
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cohort_fwd, cohort_bwd, cohort_gather = cohort_privacy_phase(dev)
    print(f"cohort and privacy phase: {time.perf_counter() - t0:.1f}s")

    # -- phase 8: the distributed backends ----------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dist_fwd, dist_bwd, dist_gather = distributed_phase(dev, phase4)
    print(f"distributed phase: {time.perf_counter() - t0:.1f}s")

    # -- phase 9: the language-model substrate (no kernel on this path) ----
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_phase(dev, nvidia_smi())
    print(f"language-model phase: {time.perf_counter() - t0:.1f}s")

    # -- phase 10: the mesh layer (no kernel on this path) -----------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_phase(nvidia_smi(), dryrun)
    print(f"mesh phase: {time.perf_counter() - t0:.1f}s")
    views = dense_view_count()
    print(f"dense (N, N) adjacency views in phases 3-10: {views} (want 0)", flush=True)
    if views:
        fail("a path of phases 3-10 materialised a dense adjacency")

    # -- phase 11: the reference API and the paper drivers -----------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    paper_phase(dev, nvidia_smi())
    print(f"paper phase: {time.perf_counter() - t0:.1f}s")

    # -- phase 12: the system benchmarks, the smokes and the examples -------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bench_launches, example_launches = benches_phase_process(nvidia_smi())
    print(f"benches and examples phase: {time.perf_counter() - t0:.1f}s")
    print(f"total {time.perf_counter() - t_start:.1f}s")

    print(f"gpu: {nvidia_smi()}")
    print(json.dumps({"kernels": [{
        "name": "cheb_attn",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cheb_attn.cu",
        "replaces": "src/repro/kernels/cheb_attn.py:146",
        "launches": (launches + train_fwd + bucket_launches + cohort_fwd + dist_fwd
                     + bench_launches["cheb_attn"] + example_launches["cheb_attn"]),
        "launches_by_path": {"serve": launches, "train": train_fwd,
                             "kernel_api": bucket_launches, "cohort": cohort_fwd,
                             "distributed": dist_fwd, "benches": bench_launches["cheb_attn"],
                             "examples": example_launches["cheb_attn"]},
        "max_abs_err": max(errs + [bucket_kernel_err]),
        "bucketed_vs_flat_err": bucket_err,
        "load": fwd_load,
        "host_ms": host_ms,
        "bucket_ms": bucket_ms,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "cheb_attn_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cheb_attn.cu",
        "replaces": "src/repro/kernels/cheb_attn.py:189",
        "launches": (train_bwd + cohort_bwd + dist_bwd + bench_launches["cheb_attn_backward"]
                     + example_launches["cheb_attn_backward"]),
        "launches_by_path": {"train": train_bwd, "cohort": cohort_bwd,
                             "distributed": dist_bwd,
                             "benches": bench_launches["cheb_attn_backward"],
                             "examples": example_launches["cheb_attn_backward"]},
        "max_abs_err": max(bwd_errs),
        "ms": ms_bwd,
        "plain_ms": ms_bwd_plain,
        "bound_ms": bwd_bound_ms,
        "bound_by": bwd_bound_by,
        "library_ms": None,
    }, {
        "name": "nbr_gather_backward",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/nbr_gather.cu",
        "replaces": None,
        "launches": (train_gather + cohort_gather + dist_gather
                     + bench_launches.get("nbr_gather_backward", 0)
                     + example_launches.get("nbr_gather_backward", 0)),
        "launches_by_path": {"train": train_gather, "cohort": cohort_gather,
                             "distributed": dist_gather,
                             "benches": bench_launches.get("nbr_gather_backward", 0),
                             "examples": example_launches.get("nbr_gather_backward", 0)},
        **gather_entry,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{src}.cu",
        "replaces": replaces,
        **api[name],
        "launches": api[name]["launches"] + bench_launches[name] + example_launches[name],
        "launches_by_path": {"kernel_api": api[name]["launches"],
                             "benches": bench_launches[name], "examples": example_launches[name]},
    } for name, src, replaces in (
        ("flash_attn", "flash_attn", "src/repro/kernels/flash_attn.py:96"),
        ("poly_attn", "poly_attn", "src/repro/kernels/poly_attn.py:99"),
        ("wkv_chunked", "wkv_chunk", "src/repro/kernels/wkv_chunk.py:93"),
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
