"""repro_torch's sequence kernels (flash_attn, poly_attn, wkv_chunked) and the
degree-bucketed layer against the JAX package.

On the CPU each wrapper runs its plain version, which follows the TPU
kernel; the JAX side runs its Pallas kernels in interpret mode with the
block sizes of ``tests/test_kernels.py``, and its jnp oracles. Inputs are
made with numpy from a seed and handed to both. Tolerances are the
reference tests' own for the same functions (``tests/test_kernels.py``,
``tests/test_bucketed_kernel.py``). The CUDA kernels are held against the
plain versions by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on
the card.
"""
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.chebyshev import attention_series
from repro.core.gat import init_gat_layer
from repro.graphs import make_cora_like as jmake_cora_like
from repro.graphs import make_graph as jmake_graph
from repro.kernels import flash_attn as jflash_attn
from repro.kernels import ops as jops
from repro.kernels import poly_attn as jpoly_attn
from repro.kernels import ref as jref
from repro.kernels.wkv_chunk import wkv_chunked as jwkv_chunked
import jax

from repro_torch.core.fedgat_model import params_from_numpy
from repro_torch.kernels import _build, flash_attn, ops, poly_attn, ref, wkv_chunked

torch.set_num_threads(1)

FLASH_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),     # tests/test_kernels.py:10
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
POLY_TOL = dict(rtol=5e-4, atol=5e-4)                   # tests/test_kernels.py:136
WKV_TOL = dict(rtol=1e-4, atol=1e-4)                    # tests/test_kernels.py:208-209
LAYER_TOL = dict(rtol=1e-4, atol=5e-5)      # port vs JAX layer, tests/test_kernel_engine.py:149
ATT8 = attention_series(8, (-4.0, 4.0)).astype(np.float32)
MODULES = {name: importlib.import_module(f"repro_torch.kernels.{name}")
           for name in ("flash_attn", "poly_attn", "wkv_chunk")}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(t):
    return t.detach().float().numpy()


def _qkv(seed, b, h, s, hd, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, s, hd)) * scale).astype(np.float32) for _ in range(3)]


# ---------------------------------------------------------------------------
# flash_attn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,hd,bq,bk", [
    (32, 16, 16, 16), (64, 64, 32, 16), (128, 128, 128, 64), (96, 32, 32, 32),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_matches_jax_kernel_and_oracle(s, hd, bq, bk, causal):
    q, k, v = _qkv(s + hd, 2, 2, s, hd)
    got = _np(flash_attn(*_t(q, k, v), causal=causal))
    want_kernel = np.asarray(jflash_attn(q, k, v, causal=causal, block_q=bq, block_k=bk))
    want_oracle = np.asarray(jref.flash_attn_ref(q, k, v, causal=causal))
    np.testing.assert_allclose(got, want_kernel, **FLASH_TOL["float32"])
    np.testing.assert_allclose(got, want_oracle, **FLASH_TOL["float32"])
    port_oracle = _np(ref.flash_attn_ref(*_t(q, k, v), causal=causal))
    np.testing.assert_allclose(port_oracle, want_oracle, **FLASH_TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attn_dtypes(dtype):
    q, k, v = _qkv(7, 1, 2, 64, 32)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (t.to(getattr(torch, dtype)) for t in _t(q, k, v))
    got = flash_attn(tq, tk, tv)
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(jflash_attn(jq, jk, jv, block_q=32, block_k=32), np.float32)
    np.testing.assert_allclose(_np(got), want, **FLASH_TOL[dtype])
    want = np.asarray(jref.flash_attn_ref(jq, jk, jv), np.float32)
    np.testing.assert_allclose(_np(got), want, **FLASH_TOL[dtype])


def test_flash_attn_rows_convex():
    """Output rows are convex combinations of V rows: bounded by V extremes."""
    q, k, v = _qkv(0, 1, 1, 32, 8)
    out = flash_attn(*_t(q, k, v))
    assert float(out.max()) <= float(v.max()) + 1e-5
    assert float(out.min()) >= float(v.min()) - 1e-5


# ---------------------------------------------------------------------------
# poly_attn
# ---------------------------------------------------------------------------

def _poly_inputs(seed, s, hd, b=2, h=2, scale=1.0):
    q, k, v = _qkv(seed, b, h, s, hd, scale)
    rng = np.random.default_rng(seed + 1)
    a1, a2 = ((rng.standard_normal((h, hd)) * 0.1).astype(np.float32) for _ in range(2))
    return q, k, v, a1, a2


@pytest.mark.parametrize("s,hd,bq,bk", [(32, 16, 16, 16), (64, 64, 32, 32), (128, 32, 64, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_poly_attn_matches_jax_kernel_and_oracle(s, hd, bq, bk, causal):
    q, k, v, a1, a2 = _poly_inputs(s, s, hd)
    got = _np(poly_attn(*_t(q, k, v, a1, a2, ATT8), causal=causal))
    want_kernel = np.asarray(jpoly_attn(q, k, v, a1, a2, ATT8, causal=causal,
                                        block_q=bq, block_k=bk))
    want_oracle = np.asarray(jref.poly_attn_ref(q, k, a1, a2, v, ATT8, causal=causal))
    np.testing.assert_allclose(got, want_kernel, **POLY_TOL)
    np.testing.assert_allclose(got, want_oracle, **POLY_TOL)
    port_oracle = _np(ref.poly_attn_ref(*_t(q, k, a1, a2, v, ATT8), causal=causal))
    np.testing.assert_allclose(port_oracle, want_oracle, **POLY_TOL)


def test_poly_attn_matches_softmax_at_high_degree():
    """With a high-degree series of exp(LeakyReLU) and small scores, polynomial
    attention approaches the exact exp-weighted aggregation (the reference's
    own convergence check, O(1/p) from the kink at 0)."""
    q, k, v, a1, a2 = _poly_inputs(0, 32, 16, b=1, h=1)
    q, k = q * 0.3, k * 0.3
    sq = np.einsum("bhqd,hd->bhq", q, a1)
    sk = np.einsum("bhkd,hd->bhk", k, a2)
    x = sq[..., :, None] + sk[..., None, :]
    e = np.exp(np.where(x >= 0, x, 0.2 * x)) * np.tril(np.ones((32, 32)))[None, None]
    want = np.einsum("bhqk,bhkd->bhqd", e, v) / e.sum(-1, keepdims=True)
    errs = []
    for p in (8, 16, 32):
        coeffs = attention_series(p, (-4.0, 4.0)).astype(np.float32)
        got = _np(poly_attn(*_t(q, k, v, a1, a2, coeffs), causal=True))
        errs.append(float(np.abs(got - want).max()))
    assert errs[2] < errs[0]
    assert errs[2] < 2e-2


@pytest.mark.parametrize("causal", [True, False])
def test_poly_attn_negative_denominators_follow_the_tpu_kernel(causal):
    """With the series negated every denominator is negative. The port and the
    Pallas kernel (``where(|den| < 1e-9, 1e-9, den)``) divide by it; the
    reference's oracle (``maximum(den, 1e-9)``) divides by 1e-9 instead and
    disagrees. If the oracle is ever fixed, the last assertion fails."""
    q, k, v, a1, a2 = _poly_inputs(3, 64, 32)
    neg = -ATT8
    got = _np(poly_attn(*_t(q, k, v, a1, a2, neg), causal=causal))
    want_kernel = np.asarray(jpoly_attn(q, k, v, a1, a2, neg, causal=causal,
                                        block_q=32, block_k=32))
    np.testing.assert_allclose(got, want_kernel, **POLY_TOL)
    oracle = np.asarray(jref.poly_attn_ref(q, k, a1, a2, v, neg, causal=causal))
    # The oracles divide by 1e-9 here: compare their numerators, num = out * 1e-9.
    port_oracle = _np(ref.poly_attn_ref(*_t(q, k, a1, a2, v, neg), causal=causal))
    np.testing.assert_allclose(port_oracle * 1e-9, oracle * 1e-9, **POLY_TOL)
    den = np.asarray(jref.poly_attn_ref(q, k, a1, a2, np.ones_like(v), neg, causal=causal))
    assert (den < 0).all()                     # num/1e-9 with num = den < 0
    assert not np.allclose(got, oracle, **POLY_TOL)
    assert np.abs(oracle).min() > 1e3 * np.abs(got).max()


# ---------------------------------------------------------------------------
# wkv_chunked
# ---------------------------------------------------------------------------

def _wkv_inputs(seed, bh, s, hd, strong=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((bh, s, hd)).astype(np.float32) for _ in range(3))
    if strong:
        w = np.full((bh, s, hd), 0.3, np.float32)
        S0 = np.zeros((bh, hd, hd), np.float32)
    else:
        w = (0.99 / (1.0 + np.exp(-(rng.standard_normal((bh, s, hd)) + 1.0)))).astype(np.float32)
        S0 = (rng.standard_normal((bh, hd, hd)) * 0.1).astype(np.float32)
    u = (rng.standard_normal(hd) * 0.1).astype(np.float32)
    return r, k, v, w, u, S0


@pytest.mark.parametrize("s,hd,chunk", [(32, 8, 8), (64, 16, 16), (128, 64, 32), (48, 16, 16)])
def test_wkv_chunked_matches_jax_kernel_and_scan(s, hd, chunk):
    args = _wkv_inputs(s + hd, 3, s, hd)
    y, sf = wkv_chunked(*_t(*args), chunk=chunk)
    jy, jsf = jwkv_chunked(*args, chunk=chunk)
    ry, rsf = jref.wkv_ref(*args)
    for got, want in ((y, jy), (sf, jsf), (y, ry), (sf, rsf)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), np.asarray(want), **WKV_TOL)
    py, psf = ref.wkv_ref(*_t(*args))
    np.testing.assert_allclose(_np(py), np.asarray(ry), **WKV_TOL)
    np.testing.assert_allclose(_np(psf), np.asarray(rsf), **WKV_TOL)


def test_wkv_chunked_strong_decay_envelope():
    """Per-channel decays as low as 0.3 stay accurate at chunk 16 (the 1/P
    range bound of the chunked form), at the reference's 1e-3."""
    args = _wkv_inputs(9, 2, 32, 8, strong=True)
    y, _ = wkv_chunked(*_t(*args), chunk=16)
    ry, _ = jref.wkv_ref(*args)
    jy, _ = jwkv_chunked(*args, chunk=16)
    np.testing.assert_allclose(_np(y), np.asarray(ry), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(_np(y), np.asarray(jy), rtol=1e-3, atol=1e-3)


def test_wkv_chunked_rejects_a_chunk_that_does_not_divide_s():
    args = _t(*_wkv_inputs(0, 2, 48, 8))
    with pytest.raises(ValueError, match="multiple of chunk"):
        wkv_chunked(*args, chunk=32)
    with pytest.raises(ValueError, match="multiple of chunk"):
        jwkv_chunked(*(a.numpy() for a in args), chunk=32)
    y, _ = wkv_chunked(*args, chunk=64)                # min(chunk, S) = S divides S
    assert y.shape == (2, 48, 8)


# ---------------------------------------------------------------------------
# ragged S and hd: the port takes any S; the JAX oracles do too
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_ragged_shapes_match_the_jax_oracles(causal):
    s, hd = 50, 24
    q, k, v = _qkv(50, 2, 3, s, hd)
    np.testing.assert_allclose(_np(flash_attn(*_t(q, k, v), causal=causal)),
                               np.asarray(jref.flash_attn_ref(q, k, v, causal=causal)),
                               **FLASH_TOL["float32"])
    q, k, v, a1, a2 = _poly_inputs(51, s, hd, h=3)
    np.testing.assert_allclose(_np(poly_attn(*_t(q, k, v, a1, a2, ATT8), causal=causal)),
                               np.asarray(jref.poly_attn_ref(q, k, a1, a2, v, ATT8,
                                                             causal=causal)), **POLY_TOL)
    args = _wkv_inputs(52, 3, s, hd)
    y, sf = wkv_chunked(*_t(*args), chunk=10)
    ry, rsf = jref.wkv_ref(*args)
    np.testing.assert_allclose(_np(y), np.asarray(ry), **WKV_TOL)
    np.testing.assert_allclose(_np(sf), np.asarray(rsf), **WKV_TOL)


# ---------------------------------------------------------------------------
# degree-bucketed layer (tests/test_bucketed_kernel.py)
# ---------------------------------------------------------------------------

def _skewed_graph(seed=0, n=96, d=16, hub_degree=40):
    """A graph with a few hubs, so the flat B is far above the typical degree
    (the reference test's graph, built by the reference's make_graph)."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((n, n), dtype=bool)
    bg = np.triu(rng.random((n, n)) < 0.04, k=1)
    adj |= bg | bg.T
    for hub in (0, 1):
        nbrs = rng.choice(np.arange(2, n), size=hub_degree, replace=False)
        adj[hub, nbrs] = True
        adj[nbrs, hub] = True
    feats = rng.random((n, d)).astype(np.float32)
    labels = rng.integers(0, 3, size=n).astype(np.int32)
    tr = rng.random(n) < 0.3
    return jmake_graph(feats, labels, adj, tr, ~tr, np.zeros(n, bool), 3)


@pytest.mark.parametrize("seed", [0, 1])
def test_degree_bucket_plan_equals_the_reference(seed):
    g = _skewed_graph(seed)
    for kwargs in ({}, {"pad_multiple": 4, "max_buckets": 2}, {"max_buckets": 8}):
        got = ops.degree_bucket_plan(g.nbr_mask, **kwargs)
        want = jops.degree_bucket_plan(g.nbr_mask, **kwargs)
        assert [cap for _, cap in got] == [cap for _, cap in want]
        for (rows, _), (jrows, _) in zip(got, want):
            np.testing.assert_array_equal(rows, jrows)


@pytest.mark.parametrize("heads", [1, 2])
def test_bucketed_layer_matches_jax_and_the_flat_layer(heads):
    g = _skewed_graph(seed=1)
    jparams = init_gat_layer(jax.random.PRNGKey(0), g.feature_dim, 8, heads)
    coeffs = np.linspace(1.0, 0.1, 5).astype(np.float32)
    want = np.asarray(jops.cheb_attn_layer_bucketed(
        jparams, jnp.asarray(coeffs), jnp.asarray(g.features), g.nbr_idx, g.nbr_mask))
    params = params_from_numpy([jparams], device="cpu")[0]
    h = torch.from_numpy(np.asarray(g.features))
    got = ops.cheb_attn_layer_bucketed(params, torch.from_numpy(coeffs), h,
                                       g.nbr_idx, g.nbr_mask)
    flat = ops.cheb_attn_layer(params, torch.from_numpy(coeffs), h,
                               torch.from_numpy(g.nbr_idx).long(),
                               torch.from_numpy(g.nbr_mask))
    np.testing.assert_allclose(_np(got), want, **LAYER_TOL)
    np.testing.assert_allclose(_np(got), _np(flat), rtol=1e-6, atol=1e-6)
    (grad,) = torch.autograd.grad(got.sum(), params["W"])
    (flat_grad,) = torch.autograd.grad(flat.sum(), params["W"])
    np.testing.assert_allclose(_np(grad), _np(flat_grad), rtol=1e-5, atol=1e-5)


def test_bucketed_layer_single_bucket_degenerates_to_flat():
    g = jmake_cora_like("tiny")
    jparams = init_gat_layer(jax.random.PRNGKey(1), g.feature_dim, 4, 2)
    params = params_from_numpy([jparams], device="cpu")[0]
    coeffs = torch.tensor([1.0, 0.5, 0.25])
    h = torch.from_numpy(np.asarray(g.features))
    one = ops.cheb_attn_layer_bucketed(params, coeffs, h, g.nbr_idx, g.nbr_mask,
                                       plan=[(np.arange(g.num_nodes), g.max_degree)])
    flat = ops.cheb_attn_layer(params, coeffs, h, torch.from_numpy(g.nbr_idx).long(),
                               torch.from_numpy(g.nbr_mask))
    np.testing.assert_allclose(_np(one), _np(flat), atol=1e-6)


def test_bucketed_layer_takes_tensor_inputs():
    """Graph arrays and plan rows given as tensors (as a caller that keeps the
    graph on the device holds them) give the numpy inputs' output exactly."""
    g = _skewed_graph(seed=0)
    jparams = init_gat_layer(jax.random.PRNGKey(2), g.feature_dim, 8, 2)
    params = params_from_numpy([jparams], device="cpu")[0]
    coeffs = torch.tensor([1.0, 0.5, 0.25])
    h = torch.from_numpy(np.asarray(g.features))
    plan = ops.degree_bucket_plan(g.nbr_mask)
    want = ops.cheb_attn_layer_bucketed(params, coeffs, h, g.nbr_idx, g.nbr_mask, plan=plan)
    idx_t, mask_t = torch.from_numpy(g.nbr_idx).long(), torch.from_numpy(g.nbr_mask)
    tensor_plan = [(torch.from_numpy(rows), cap) for rows, cap in plan]
    for kwargs in ({}, {"plan": tensor_plan}):
        got = ops.cheb_attn_layer_bucketed(params, coeffs, h, idx_t, mask_t, **kwargs)
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the wrappers: CPU plain path, no fallback, the package's names
# ---------------------------------------------------------------------------

def _small_call(name, device="cpu", dtype=torch.float32):
    """One small call of each wrapper on tensors of ``device``."""
    if name == "flash_attn":
        q, k, v = (torch.ones(1, 2, 8, 4, dtype=dtype, device=device) for _ in range(3))
        return flash_attn(q, k, v)
    if name == "poly_attn":
        q, k, v = (torch.ones(1, 2, 8, 4, dtype=dtype, device=device) for _ in range(3))
        a = torch.ones(2, 4, device=device)
        return poly_attn(q, k, v, a, a, torch.ones(3, device=device))
    r = torch.ones(2, 8, 4, dtype=dtype, device=device)
    return wkv_chunked(r, r, r, r * 0.5, torch.ones(4, device=device),
                       torch.zeros(2, 4, 4, device=device), chunk=4)


WRAPPERS = {"flash_attn": flash_attn, "poly_attn": poly_attn, "wkv_chunk": wkv_chunked}


@pytest.mark.parametrize("module", sorted(MODULES))
def test_cpu_calls_launch_no_kernel(module):
    fn = WRAPPERS[module]
    before = fn.launches
    _small_call(fn.__name__)
    assert fn.launches == before == 0


@pytest.mark.parametrize("module", sorted(MODULES))
def test_non_cpu_request_raises_when_the_library_cannot_load(module, monkeypatch):
    """No fallback to the plain version: a tensor off the CPU goes to the
    kernel, and a kernel that cannot be built raises."""
    def no_library(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(MODULES[module], "_lib", None)
    monkeypatch.setattr(_build, "load_library", no_library)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _small_call(WRAPPERS[module].__name__, device="meta")


@pytest.mark.parametrize("module", sorted(MODULES))
def test_non_cuda_device_is_refused_by_the_wrapper(module, monkeypatch):
    fn = WRAPPERS[module]
    monkeypatch.setattr(MODULES[module], "_lib", object())
    before = fn.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        _small_call(fn.__name__, device="meta")
    assert fn.launches == before


def test_shapes_are_checked_before_either_path():
    q = torch.ones(1, 2, 8, 4)
    with pytest.raises(ValueError, match="one shape"):
        flash_attn(q, q, torch.ones(1, 2, 8, 5))
    with pytest.raises(ValueError, match=r"\(H, hd\)"):
        poly_attn(q, q, q, torch.ones(3, 4), torch.ones(2, 4), torch.ones(3))
    r = torch.ones(2, 8, 4)
    with pytest.raises(ValueError, match="S0"):
        wkv_chunked(r, r, r, r, torch.ones(4), torch.zeros(2, 4, 5))


@pytest.mark.parametrize("hd,c,dtype,align,want", [
    (64, 16, torch.float32, 16, dict(path="fast", consumer_warps=4, decay_warps=4, threads=288,
                                     stages=3, smem_bytes=109952, load="bulk")),
    (64, 16, torch.bfloat16, 16, dict(path="fast", threads=288, stages=3, smem_bytes=85376,
                                      load="bulk")),
    (64, 16, torch.float32, 4, dict(path="fast", load="cp.async")),
    (128, 16, torch.float32, 16, dict(path="fast", consumer_warps=8, decay_warps=4,
                                      threads=416, smem_bytes=215936)),
    (16, 16, torch.bfloat16, 16, dict(path="fast", consumer_warps=1, decay_warps=1,
                                      threads=96)),
    (48, 16, torch.float32, 4, dict(path="fast", consumer_warps=3, decay_warps=3,
                                    load="cp.async")),
    (24, 10, torch.float32, 16, dict(path="general", threads=256, stages=1, smem_bytes=9840,
                                     load="plain")),
    (24, 16, torch.float32, 16, dict(path="general")),
    (64, 32, torch.bfloat16, 16, dict(path="general", smem_bytes=79104)),
    (8, 8, torch.float32, 16, dict(path="general")),
    (64, 16, torch.bfloat16, 2, dict(path="general", smem_bytes=46848, load="plain")),
], ids=["rwkv6-f32", "rwkv6-bf16", "rwkv6-misaligned", "hd128", "hd16", "hd48-misaligned",
        "hd24-c10", "hd24-c16", "c32", "hd8-c8", "rwkv6-bf16-2B"])
def test_wkv_launch_plan_names_the_path(hd, c, dtype, align, want):
    """Chunk 16 with hd a multiple of 16 up to 128 and 4-byte-aligned bases
    takes the fast path (bulk copies when the bases are 16-byte aligned),
    every other call the general one with its shared memory."""
    wkv = MODULES["wkv_chunk"]
    plan = wkv.launch_plan(hd, c, dtype, align)
    assert {key: plan[key] for key in want} == want
    if plan["path"] == "general":
        assert plan["smem_bytes"] == wkv.shared_bytes(hd, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wkv_fast_path_fits_shared_memory_for_every_head_dim(dtype):
    """Every fast-path hd fits a block's shared memory, and up to hd 64 two
    blocks share an SM (228 KB, 1 KB of it reserved per block)."""
    wkv = MODULES["wkv_chunk"]
    for hd in range(16, wkv.MAX_HEAD_DIM + 1, 16):
        plan = wkv.launch_plan(hd, 16, dtype)
        assert plan["path"] == "fast" and plan["stages"] == 3
        assert plan["smem_bytes"] <= wkv._SMEM_MAX
        if hd <= 64:
            assert 2 * (plan["smem_bytes"] + 1024) <= 228 * 1024
    with pytest.raises(ValueError, match="head dim"):
        wkv.launch_plan(wkv.MAX_HEAD_DIM + 16, 16, dtype)


def test_wkv_shared_memory_matches_the_kernel_limits():
    assert wkv_chunked.__module__ == "repro_torch.kernels.wkv_chunk"
    wkv = MODULES["wkv_chunk"]
    assert wkv.shared_bytes(64, 16) <= 48 * 1024                 # rwkv6-1.6b: no opt-in
    assert wkv.shared_bytes(wkv.MAX_HEAD_DIM, 32) <= wkv._SMEM_MAX
    assert wkv.shared_bytes(wkv.MAX_HEAD_DIM, 64) > wkv._SMEM_MAX


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_launch_plan_fits_shared_memory_for_every_head_dim(dtype):
    """Every hd in 1..256: the query tile and two stages of key and value
    tiles fit the 227 KB a block can have, hd pads to whole 128-byte panels
    (64 bf16 or 32 float32 columns; 64 at least), and the block is 16
    (bf16) or 32 (float32 up to hd 128) query rows per consumer warp plus a
    producer warpgroup."""
    plan_of = MODULES["flash_attn"].launch_plan
    size = 2 if dtype == torch.bfloat16 else 4
    for hd in range(1, 257):
        plan = plan_of(4096, hd, dtype)
        assert plan["smem_bytes"] <= 227 * 1024, hd
        assert plan["smem_bytes"] == 2048 + (plan["block_m"] + 4 * plan["block_n"]) * \
            plan["hd_pad"] * size
        assert hd <= plan["hd_pad"] < hd + 128 and plan["hd_pad"] % 64 == 0
        assert plan["rows_per_warp"] == (16 if size == 2 or plan["hd_pad"] == 256 else 32)
        assert plan["threads"] == 32 * (plan["block_m"] // plan["rows_per_warp"]) + 128
        assert plan["block_n"] % (16 if size == 2 else 8) == 0
        assert plan["blocks_per_head"] == -(-4096 // plan["block_m"])
        assert plan["mma"] == ("wgmma" if size == 2 else "mma.sync 3xTF32")


@pytest.mark.parametrize("align", [16, 8, 4, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_launch_plan_takes_tma_exactly_when_a_descriptor_describes_the_tensor(dtype, align):
    """TMA exactly when hd * itemsize is a multiple of 16 bytes and the base
    pointers are 16-byte aligned; otherwise cp.async, with 4-byte copies
    unless bf16 rows are not 4-byte granular."""
    plan_of = MODULES["flash_attn"].launch_plan
    size = 2 if dtype == torch.bfloat16 else 4
    for hd in range(1, 257):
        plan = plan_of(130, hd, dtype, align)
        tma = (hd * size) % 16 == 0 and align % 16 == 0
        assert (plan["load"] == "tma") == tma, hd
        if not tma:
            word = size == 4 or (hd % 2 == 0 and align % 4 == 0)
            assert plan["copy_bytes"] == (4 if word else 2), hd


def test_flash_launch_plan_refuses_what_the_kernel_does_not_take():
    plan_of = MODULES["flash_attn"].launch_plan
    with pytest.raises(ValueError, match="head dim"):
        plan_of(16, 257, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        plan_of(16, 64, torch.float16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_poly_launch_plan_fits_shared_memory_for_every_head_dim(dtype):
    """Every hd in 1..256: as many stages of a key and a value tile as fit
    the 227 KB a block can have (at most 4, at least 2) beside 4 KB for the
    alignment, barriers, coefficients, sk and a2; hd pads to whole 64-column
    panels; 8 consumer warps of 16 query rows per m-tile (two m-tiles for
    float32 up to hd 128) plus a producer warpgroup; key tiles of 64 (bf16
    up to hd 128) or 32 keys, k-steps of wgmma (16) and mma.sync (8)."""
    plan_of = MODULES["poly_attn"].launch_plan
    size = 2 if dtype == torch.bfloat16 else 4
    for hd in range(1, 257):
        plan = plan_of(4096, hd, dtype)
        stage = 2 * plan["block_n"] * plan["hd_pad"] * size
        assert 2 <= plan["stages"] <= 4, hd
        assert plan["smem_bytes"] == 4096 + plan["stages"] * stage <= 227 * 1024, hd
        assert plan["stages"] == 4 or 4096 + (plan["stages"] + 1) * stage > 227 * 1024, hd
        assert hd <= plan["hd_pad"] < hd + 128 and plan["hd_pad"] % 64 == 0
        assert plan["rows_per_warp"] == (32 if size == 4 and plan["hd_pad"] <= 128 else 16)
        assert plan["block_m"] == 8 * plan["rows_per_warp"] and plan["threads"] == 8 * 32 + 128
        assert plan["block_n"] == (64 if size == 2 and plan["hd_pad"] <= 128 else 32)
        assert plan["blocks_per_head"] == -(-4096 // plan["block_m"])
        assert plan["mma"] == ("wgmma bf16 pair" if size == 2 else "mma.sync 3xTF32")
        # The sk row of every stage and a2 fit their 1 KB each.
        assert 4 * plan["stages"] * plan["block_n"] <= 1024 and 4 * plan["hd_pad"] <= 1024


@pytest.mark.parametrize("align", [16, 8, 4, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_poly_launch_plan_takes_tma_exactly_when_a_descriptor_describes_the_tensor(dtype, align):
    """TMA exactly when hd * itemsize is a multiple of 16 bytes and the key
    and value bases are 16-byte aligned; otherwise cp.async, with 4-byte
    copies unless bf16 rows are not 4-byte granular."""
    plan_of = MODULES["poly_attn"].launch_plan
    size = 2 if dtype == torch.bfloat16 else 4
    for hd in range(1, 257):
        plan = plan_of(130, hd, dtype, align)
        tma = (hd * size) % 16 == 0 and align % 16 == 0
        assert (plan["load"] == "tma") == tma, hd
        if not tma:
            word = size == 4 or (hd % 2 == 0 and align % 4 == 0)
            assert plan["copy_bytes"] == (4 if word else 2), hd


def test_poly_launch_plan_refuses_what_the_kernel_does_not_take():
    plan_of = MODULES["poly_attn"].launch_plan
    with pytest.raises(ValueError, match="head dim"):
        plan_of(16, 257, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        plan_of(16, 0, torch.bfloat16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        plan_of(16, 64, torch.float16)


def test_flash_alignment_reads_the_base_pointers():
    """The wrapper's alignment, from which launch_plan picks the load path:
    a contiguous view one float past an allocation is 4-byte aligned only."""
    align_of = MODULES["flash_attn"]._alignment
    base = torch.empty(1 + 2 * 3 * 8 * 4)
    assert base.data_ptr() % 16 == 0
    view = base[1:].view(2, 3, 8, 4)
    assert view.is_contiguous() and align_of(base) == 16
    assert align_of(base, view) == 4
    assert align_of(base.bfloat16()[1:]) == 2


def test_ops_all_mirrors_the_reference():
    """Every name of ``repro.kernels.ops.__all__`` that the port has, and no
    other; the three left out drive the TPU's block model and interpret mode,
    and ``cheb_attn_diff`` is ``cheb_attn`` itself (an autograd Function)."""
    left_out = {"cheb_attn_diff", "resolve_interpret", "select_block_sizes",
                "clear_block_cache"}
    assert set(ops.__all__) == set(jops.__all__) - left_out
    assert all(hasattr(ops, name) for name in ops.__all__)
    import repro_torch.kernels as kernels
    assert kernels.flash_attn is flash_attn and kernels.poly_attn is poly_attn
    assert kernels.wkv_chunked is wkv_chunked and kernels.ref is ref and kernels.ops is ops


def test_kernel_modules_import_first_in_a_fresh_process():
    """``repro_torch.kernels.ops`` imported before ``repro_torch.core`` used to
    fail with a circular import (core's engines import ops)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    for mod in ("repro_torch.kernels.ops", "repro_torch.kernels"):
        proc = subprocess.run(
            [sys.executable, "-c", f"import {mod}"], capture_output=True, text=True,
            timeout=120, cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
        )
        assert proc.returncode == 0, proc.stderr
