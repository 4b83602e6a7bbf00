"""The CUDA kernels against their plain versions, and a short federated
training run on the card against the same run on the CPU.

Tolerances: cheb_attn as ``chip_smoke.py``; the sequence kernels at the
reference tests' own (``tests/test_kernels.py``: flash f32 2e-4/2e-5, bf16
2e-2; poly 5e-4; wkv 1e-4). flash and poly are also held at their tile
edges (S around the key tiles and the query blocks, hd around the 64-column
panels) and on both load paths (TMA, cp.async); the cheb_attn forward on
both of its load paths (bulk copies, cp.async), at N around its node tile,
in every layout and with D cut into chunks; the backward at the training
shape, at B 1 and D 1, with D cut into chunks, and for every subset of the
cotangents; wkv_chunked on the path its ``launch_plan`` names, the fast
one at hd 16-128 on both load paths (bulk copies, cp.async) and with
strong decay. The pack engines (``matrix``, ``vector``; plain PyTorch, no
kernel) on the card against the CPU at ``tiny`` and ``sbm_1k``, their
training, a pack cache saved on the CPU and loaded onto the card, and a
server's refresh bit for bit. The privacy stack on the card: DP noise and
pairwise masks equal the CPU's (both are drawn on CPU generators), pack
noise drawn on the card with its calibrated std, and cohort training with
DP, pairwise masks or the protocol against the same run on the CPU. The
shard_map backend on the card: one process (one-lane cohorts) against the
loop with exact launch counts, two ranks sharing card 0 over gloo, and
two ranks with a card each over NCCL (skipped with fewer than two cards).

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.
"""
import copy
import importlib
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import FedGATConfig
from repro_torch.core.chebyshev import attention_series
from repro_torch.federated import FederatedConfig, run_federated
from repro_torch.graphs import make_cora_like
from repro_torch.kernels import flash_attn, ops, poly_attn, wkv_chunked
from repro_torch.kernels.cheb_attn import cheb_attn, cheb_attn_backward
from repro_torch.kernels.flash_attn import flash_attn_plain
from repro_torch.kernels.poly_attn import poly_attn_plain
from repro_torch.kernels.ref import cheb_attn_bwd_ref, cheb_attn_ref, wkv_ref
from repro_torch.kernels.wkv_chunk import wkv_chunked_plain

WKV = importlib.import_module("repro_torch.kernels.wkv_chunk")

ATT16 = attention_series(16, (-4.0, 4.0)).astype(np.float32)


def _inputs(lead, glead, n, b, d, seed=0):
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(lead + (n, b)), -3.5, 3.5).astype(np.float32)
    h = rng.standard_normal(glead + (n, b, d)).astype(np.float32)
    m = (rng.random(glead + (n, b)) < 0.7).astype(np.float32)
    m[..., 0] = 1.0
    m[..., 5, :] = 0.0                          # an isolated row
    x[..., 9, :] = -6.0                         # series < 0 there: negative denominator
    m[..., 9, :] = 1.0
    return x, h * m[..., None], m


@pytest.mark.cuda
@pytest.mark.parametrize("lead,glead", [((), ()), ((8,), ()), ((3, 4), (3,))],
                         ids=["2d", "3d", "4d"])
def test_cuda_kernel_matches_plain_version(lead, glead):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    x, h, m = _inputs(lead, glead, n=1001, b=24, d=48)
    args = [torch.from_numpy(a).cuda() for a in (x, h, m, ATT16)]
    before = cheb_attn.launches
    got = cheb_attn(*args)
    torch.cuda.synchronize()
    assert cheb_attn.launches == before + 1
    want = cheb_attn_ref(*args)
    # FMA contraction and summation order differ from the plain version.
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert (got[..., 5, :] == 0).all()
    assert (want[..., 9, :].sum(-1) != 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("lead,glead", [((), ()), ((8,), ()), ((3, 4), (3,))],
                         ids=["2d", "3d", "4d"])
def test_cuda_backward_kernel_matches_plain_version(lead, glead):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    x, h, m = _inputs(lead, glead, n=1001, b=24, d=48)
    x[..., 11, 3], m[..., 11, 3] = np.inf, 0.0   # a masked infinite score: NaN row
    dout = np.random.default_rng(1).standard_normal(x.shape[:-1] + (48,)).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (x, h, m, ATT16, dout)]
    before = cheb_attn_backward.launches
    got = cheb_attn_backward(*args)
    torch.cuda.synchronize()
    assert cheb_attn_backward.launches == before + 1
    want = cheb_attn_bwd_ref(*args)
    # The derivative of a degree-16 series cancels differently under another
    # summation order: the reference's own gradient tolerance.
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-4, equal_nan=True)
    assert (got[0][..., 5, :] == 0).all() and (got[1][..., 5, :, :] == 0).all()
    assert torch.isnan(got[0][..., 11, :]).all()


@pytest.mark.cuda
def test_cuda_training_matches_cpu_training():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = make_cora_like("tiny", seed=0)
    cfg = FederatedConfig(num_clients=4, rounds=2, local_steps=2,
                          model=FedGATConfig(engine="kernel", degree=10))
    before = (cheb_attn.launches, cheb_attn_backward.launches)
    gpu = run_federated(g, cfg, device="cuda")
    launches = (cheb_attn.launches - before[0], cheb_attn_backward.launches - before[1])
    cpu = run_federated(g, cfg, device="cpu")
    assert launches == (2 * (4 * 2 + 1), 2 * 4 * 2)
    np.testing.assert_allclose(gpu["val_curve"], cpu["val_curve"], atol=1e-6)
    np.testing.assert_allclose(gpu["test_curve"], cpu["test_curve"], atol=1e-6)
    for a, b in zip(gpu["params"].parameters(), cpu["params"].parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-3, atol=1e-4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def _randn(shape, seed, dtype=torch.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).cuda().to(dtype)


SEQ_TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
SEQ_SHAPES = [(2, 3, 130, 24), (1, 2, 64, 256), (1, 2, 200, 128)]   # ragged S and hd, max hd


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SEQ_SHAPES, ids=["ragged", "hd256", "hd128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_attn_matches_plain_version(shape, dtype, causal):
    _need_card()
    q, k, v = (_randn(shape, seed, dtype) for seed in range(3))
    before = flash_attn.launches
    got = flash_attn(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attn.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attn_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **SEQ_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SEQ_SHAPES, ids=["ragged", "hd256", "hd128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["series", "negated"])
def test_cuda_poly_attn_matches_plain_version(shape, dtype, causal, sign):
    """The negated series gives rows whose denominators are negative: they
    divide, as in the TPU kernel."""
    _need_card()
    q, k, v = (_randn(shape, seed, dtype) for seed in range(3))
    a1, a2 = (_randn(shape[1:2] + shape[3:], seed, scale=shape[3] ** -0.5) for seed in (3, 4))
    coeffs = torch.from_numpy(sign * attention_series(8, (-4.0, 4.0))).float().cuda()
    before = poly_attn.launches
    got = poly_attn(q, k, v, a1, a2, coeffs, causal=causal)
    torch.cuda.synchronize()
    assert poly_attn.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = poly_attn_plain(q, k, v, a1, a2, coeffs, causal=causal)
    tol = SEQ_TOL[dtype] if dtype == torch.bfloat16 else dict(rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


def _wkv_inputs(bh, s, hd, dtype, offset=0, strong=False):
    """r, k, v, w as the reference's tests make them (w = 0.3 everywhere and
    S0 = 0 when ``strong``); with ``offset``, r, k, v and w are contiguous
    views that start ``offset`` elements into their storage."""
    def placed(t):
        if not offset:
            return t
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
        view = buf[offset:].view(t.shape)
        view.copy_(t)
        return view

    r, k, v = (_randn((bh, s, hd), seed, dtype) for seed in range(3))
    if strong:
        w = torch.full((bh, s, hd), 0.3, device="cuda").to(dtype)
        S0 = torch.zeros((bh, hd, hd), device="cuda")
    else:
        w = (torch.sigmoid(_randn((bh, s, hd), 3) + 1.0) * 0.99).to(dtype)
        S0 = _randn((bh, hd, hd), 5, scale=0.1)
    u = _randn((hd,), 4, scale=0.1)
    return [placed(t) for t in (r, k, v, w)] + [u, S0]


def _check_wkv(args, chunk, path, load=None, ref_tol=1e-4):
    """One launch on the path ``launch_plan`` names, held against the plain
    version at 1e-4 and the scan oracle at ``ref_tol``."""
    r, k, v, w, u, S0 = args
    plan = WKV.launch_plan(r.shape[2], min(chunk, r.shape[1]), r.dtype,
                           WKV._alignment(r, k, v, w))
    assert plan["path"] == path
    if load is not None:
        assert plan["load"] == load
    before = wkv_chunked.launches
    y, sf = wkv_chunked(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_chunked.launches == before + 1
    assert y.dtype == sf.dtype == torch.float32
    py, psf = wkv_chunked_plain(*args, chunk=chunk)
    torch.testing.assert_close(y, py, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sf, psf, rtol=1e-4, atol=1e-4)
    ry, rsf = wkv_ref(*args)
    torch.testing.assert_close(y, ry, rtol=ref_tol, atol=ref_tol)
    torch.testing.assert_close(sf, rsf, rtol=ref_tol, atol=ref_tol)


# The path each shape of the test below takes: chunk 16 with hd a multiple
# of 16 is the fast path's.
WKV_PATHS = {(24, 10): "general", (128, 16): "fast", (64, 16): "fast", (64, 32): "general"}


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,hd,chunk", [(3, 50, 24, 10), (2, 64, 128, 16), (4, 128, 64, 16),
                                           (2, 96, 64, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_wkv_chunked_matches_plain_version_and_scan(bh, s, hd, chunk, dtype):
    _need_card()
    _check_wkv(_wkv_inputs(bh, s, hd, dtype), chunk, WKV_PATHS[(hd, chunk)])


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,hd", [(1, 16, 16), (3, 16, 32), (1, 16, 64), (3, 16, 128),
                                     (1, 64, 32), (3, 48, 64), (5, 32, 128), (3, 64, 48),
                                     (2, 32, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_wkv_fast_path_matches_plain_version_and_scan(bh, s, hd, dtype):
    """The fast path at hd 16-128, S = C and a few chunks, BH 1 and odd,
    fed by bulk copies."""
    _need_card()
    _check_wkv(_wkv_inputs(bh, s, hd, dtype), 16, "fast", load="bulk")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset,path,load", [
    (torch.float32, 1, "fast", "cp.async"), (torch.bfloat16, 1, "general", "plain"),
    (torch.bfloat16, 2, "fast", "cp.async")], ids=["f32-4B", "bf16-2B", "bf16-4B"])
def test_cuda_wkv_fast_path_misaligned_base(dtype, offset, path, load):
    """Bases 4-byte aligned but off 16 bytes take the fast path's cp.async
    copies into the same stage layout; a bf16 base off 4 bytes takes the
    general path."""
    _need_card()
    _check_wkv(_wkv_inputs(3, 48, 64, dtype, offset=offset), 16, path, load=load)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,hd", [(3, 48, 64), (2, 32, 128), (1, 16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_wkv_general_kernel_at_fast_path_shapes(bh, s, hd, dtype):
    """The general kernel launched at shapes the fast path takes (as
    chip_smoke.py holds it at rwkv6-1.6b's) agrees with the plain version
    and the fast path."""
    _need_card()
    args = _wkv_inputs(bh, s, hd, dtype)
    before = wkv_chunked.launches
    y, sf = WKV._launch_general(*args, 16)
    torch.cuda.synchronize()
    assert wkv_chunked.launches == before + 1
    py, psf = wkv_chunked_plain(*args, chunk=16)
    torch.testing.assert_close(y, py, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sf, psf, rtol=1e-4, atol=1e-4)
    fy, fsf = wkv_chunked(*args, chunk=16)
    torch.testing.assert_close(y, fy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sf, fsf, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_wkv_fast_path_strong_decay_envelope(dtype):
    """Decays of 0.3 on every channel (1/P up to 0.3^-16 inside a chunk) on
    the fast path: the scan oracle at the reference's 1e-3
    (test_torch_seq_kernels.py::test_wkv_chunked_strong_decay_envelope)."""
    _need_card()
    _check_wkv(_wkv_inputs(2, 64, 64, dtype, strong=True), 16, "fast", ref_tol=1e-3)


@pytest.mark.cuda
def test_cuda_sequence_kernels_refuse_what_they_do_not_take():
    _need_card()
    q = _randn((1, 2, 16, 264), 0)
    with pytest.raises(ValueError, match="head dim"):
        flash_attn(q, q, q)
    with pytest.raises(ValueError, match="head dim"):
        poly_attn(q, q, q, q[0, :, 0], q[0, :, 0], torch.ones(3, device="cuda"))
    r = _randn((2, 16, 136), 1)
    with pytest.raises(ValueError, match="head dim"):
        wkv_chunked(r, r, r, r, r[0, 0], _randn((2, 136, 136), 2))
    r = _randn((2, 48, 8), 3)
    with pytest.raises(ValueError, match="multiple of chunk"):
        wkv_chunked(r, r, r, r, r[0, 0], _randn((2, 8, 8), 4), chunk=32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attn(*(_randn((1, 2, 16, 8), 5).half() for _ in range(3)))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_bucketed_layer_matches_the_flat_layer():
    _need_card()
    g = make_cora_like("tiny", seed=0)
    params = {"W": _randn((2, g.feature_dim, 4), 1, scale=0.1),
              "a1": _randn((2, 4), 2), "a2": _randn((2, 4), 3)}
    coeffs = torch.from_numpy(ATT16).cuda()
    h = torch.from_numpy(np.asarray(g.features, np.float32)).cuda()
    plan = ops.degree_bucket_plan(g.nbr_mask)
    before = cheb_attn.launches
    got = ops.cheb_attn_layer_bucketed(params, coeffs, h, g.nbr_idx, g.nbr_mask, plan=plan)
    torch.cuda.synchronize()
    assert cheb_attn.launches == before + len(plan)
    flat = ops.cheb_attn_layer(params, coeffs, h, torch.from_numpy(g.nbr_idx).long().cuda(),
                               torch.from_numpy(g.nbr_mask).cuda())
    torch.testing.assert_close(got, flat, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_cuda_bucketed_layer_takes_device_inputs():
    _need_card()
    g = make_cora_like("tiny", seed=0)
    params = {"W": _randn((2, g.feature_dim, 4), 1, scale=0.1),
              "a1": _randn((2, 4), 2), "a2": _randn((2, 4), 3)}
    coeffs = torch.from_numpy(ATT16).cuda()
    h = torch.from_numpy(np.asarray(g.features, np.float32)).cuda()
    plan = ops.degree_bucket_plan(g.nbr_mask)
    want = ops.cheb_attn_layer_bucketed(params, coeffs, h, g.nbr_idx, g.nbr_mask, plan=plan)
    idx_d = torch.from_numpy(g.nbr_idx).long().cuda()
    mask_d = torch.from_numpy(g.nbr_mask).cuda()
    device_plan = [(torch.from_numpy(rows).cuda(), cap) for rows, cap in plan]
    for kwargs in ({}, {"plan": device_plan}):
        got = ops.cheb_attn_layer_bucketed(params, coeffs, h, idx_d, mask_d, **kwargs)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


FLASH_S = [1, 63, 64, 65, 129]
FLASH_HD = [24, 64, 100, 128, 256]


def _flash_check(shape, dtype, causal, want_load=None, offset=0):
    """flash_attn on the card against its plain version at SEQ_TOL; with
    ``offset`` the inputs start that many elements into their storage."""
    q, k, v = (_randn((int(np.prod(shape)) + offset,), seed, dtype)[offset:].view(shape)
               for seed in range(3))
    flash_mod = importlib.import_module("repro_torch.kernels.flash_attn")
    plan = flash_mod.launch_plan(shape[2], shape[3], dtype, flash_mod._alignment(q, k, v))
    if want_load is not None:
        assert plan["load"] == want_load
    before = flash_attn.launches
    got = flash_attn(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attn.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attn_plain(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), **SEQ_TOL[dtype])
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("s", FLASH_S + [4096])
@pytest.mark.parametrize("hd", FLASH_HD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_attn_tile_edges_and_load_paths(s, hd, dtype, causal):
    """Ragged S around the 64- and 128-row tiles, hd around the 64-column
    panels; bf16 hd 100 (200-byte rows) takes the cp.async path, the rest
    TMA."""
    _need_card()
    shape = (1, 1, s, hd) if s == 4096 else (2, 3, s, hd)
    size = 2 if dtype == torch.bfloat16 else 4
    _flash_check(shape, dtype, causal, "tma" if (hd * size) % 16 == 0 else "cp.async")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,offset,copy_bytes", [
    (torch.float32, 64, 1, 4), (torch.float32, 100, 3, 4), (torch.bfloat16, 64, 2, 4),
    (torch.bfloat16, 7, 0, 2), (torch.bfloat16, 64, 1, 2), (torch.bfloat16, 130, 0, 4),
], ids=["f32-4B-aligned", "f32-hd100-4B", "bf16-4B-aligned", "bf16-odd-hd", "bf16-2B-aligned",
        "bf16-hd130"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_flash_attn_cp_async_path(dtype, hd, offset, copy_bytes, causal):
    """Bases that TMA cannot take (not 16-byte aligned) and rows that are not
    16-byte multiples go through cp.async, zero-filled past S and hd."""
    _need_card()
    plan = _flash_check((2, 2, 97, hd), dtype, causal, "cp.async", offset)
    assert plan["copy_bytes"] == copy_bytes


@pytest.mark.cuda
def test_cuda_flash_attn_raises_for_a_tensor_it_cannot_take():
    """No fallback: a strided (non-contiguous) input raises, and no launch
    is counted."""
    _need_card()
    q = _randn((1, 2, 32, 128), 0)[..., :64]
    before = flash_attn.launches
    with pytest.raises(ValueError, match="contiguous"):
        flash_attn(q, q, q)
    assert flash_attn.launches == before


def _bwd_inputs(heads, n, b, d, seed=0):
    x, h, m = _inputs((heads,), (), n, b, d, seed)
    x[..., 11, min(3, b - 1)], m[..., 11, min(3, b - 1)] = np.inf, 0.0   # NaN row
    dout = np.random.default_rng(seed + 1).standard_normal((heads, n, d)).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (x, h, m, ATT16, dout)]


BWD_SHAPES = {"train": (8, 4099, 16, 16), "b1": (8, 777, 1, 16), "d1": (8, 777, 16, 1),
              "b1d1": (3, 300, 1, 1), "d-chunks": (16, 300, 64, 128), "opt-in": (64, 100, 96, 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(BWD_SHAPES), ids=list(BWD_SHAPES))
def test_cuda_backward_kernel_shapes(shape):
    """The training shape, B 1, D 1, a tile cut into D chunks (one warp per
    block) and one that opts in past 48 KB, against the plain backward:
    exact zeros on the isolated row, NaN on the masked infinite score's row."""
    _need_card()
    heads, n, b, d = BWD_SHAPES[shape]
    args = _bwd_inputs(heads, n, b, d)
    before = cheb_attn_backward.launches
    got = cheb_attn_backward(*args)
    torch.cuda.synchronize()
    assert cheb_attn_backward.launches == before + 1
    want = cheb_attn_bwd_ref(*args)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-3, atol=1e-4, equal_nan=True)
    assert (got[0][:, 5] == 0).all() and (got[1][5] == 0).all() and (got[2][5] == 0).all()
    assert torch.isnan(got[0][:, 11]).all()


NEEDS = [tuple(bool(i >> j & 1) for j in range(4)) for i in range(1, 16)]
NEEDS_IDS = ["".join("1" if n else "0" for n in needs) for needs in NEEDS]


@pytest.mark.cuda
@pytest.mark.parametrize("needs", NEEDS, ids=NEEDS_IDS)
def test_cuda_backward_kernel_each_subset_of_needs(needs):
    """Every non-empty subset of the four cotangents (training asks for dx
    alone, the kernel engine with features needing a gradient for dx and
    dh_nb): those asked for match the plain backward, the others are None."""
    _need_card()
    args = _bwd_inputs(*BWD_SHAPES["train"])
    got = cheb_attn_backward(*args, needs=needs)
    torch.cuda.synchronize()
    want = cheb_attn_bwd_ref(*args, needs)
    for need, a, w in zip(needs, got, want):
        assert (a is None) == (not need)
        if need:
            torch.testing.assert_close(a, w, rtol=1e-3, atol=1e-4, equal_nan=True)


# Shapes that take the register path (B a power of two up to 32, H*B 32, 64
# or 128, one D chunk) for every instance: H*B 32 (one item per lane), 64
# (two) and 128 (four), B from 2 to 32, and a D that is no multiple of 4
# (the h_nb and dout rows read one float at a time).
REGISTER_SHAPES = {"hb32-h2b16": (2, 1001, 16, 16), "hb32-h1b32": (1, 1001, 32, 16),
                   "hb32-h16b2": (16, 1001, 2, 16), "hb64-h8b8": (8, 1001, 8, 16),
                   "hb64-h4b16": (4, 1001, 16, 12), "hb128-h32b4": (32, 1001, 4, 8),
                   "hb128-d15": (8, 1001, 16, 15)}
REGISTER_NEEDS = [(True, False, False, False), (False, False, True, False),
                  (True, False, True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("needs", REGISTER_NEEDS, ids=["dx", "dmask", "dx-dmask"])
@pytest.mark.parametrize("shape", list(REGISTER_SHAPES), ids=list(REGISTER_SHAPES))
def test_cuda_backward_register_path_instances(shape, needs):
    """The requests without dh_nb and dcoeffs, at shapes that run each
    instance of the register path, against the plain backward: exact zeros
    on the isolated row, NaN on the masked infinite score's row."""
    _need_card()
    heads, n, b, d = REGISTER_SHAPES[shape]
    args = _bwd_inputs(heads, n, b, d)
    got = cheb_attn_backward(*args, needs=needs)
    torch.cuda.synchronize()
    want = cheb_attn_bwd_ref(*args, needs)
    for need, a, w in zip(needs, got, want):
        assert (a is None) == (not need)
        if need:
            torch.testing.assert_close(a, w, rtol=1e-3, atol=1e-4, equal_nan=True)
    if needs[0]:
        assert (got[0][:, 5] == 0).all() and torch.isnan(got[0][:, 11]).all()
    if needs[2]:
        assert (got[2][5] == 0).all()


@pytest.mark.cuda
def test_cuda_backward_dcoeffs_does_not_depend_on_block_order():
    """dcoeffs sums per-block partials in a second pass, over nodes given to
    warps in a fixed order: two runs agree bit for bit."""
    _need_card()
    x, h, m, coeffs, dout = _bwd_inputs(*BWD_SHAPES["train"])
    x[:, 11] = 0.5                                               # finite dcoeffs
    needs = (False, False, False, True)
    first = cheb_attn_backward(x, h, m, coeffs, dout, needs)[3]
    second = cheb_attn_backward(x, h, m, coeffs, dout, needs)[3]
    torch.cuda.synchronize()
    assert torch.isfinite(first).all() and torch.equal(first, second)
    torch.testing.assert_close(first, cheb_attn_bwd_ref(x, h, m, coeffs, dout, needs)[3],
                               rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# The cheb_attn forward: load paths, tile edges, layouts
# ---------------------------------------------------------------------------

def _offset_tensor(a, offset):
    """``a`` on the card, starting ``offset`` floats into its storage (a
    contiguous view whose base is 4-byte aligned only, for offset 1-3)."""
    flat = torch.empty(a.size + offset, dtype=torch.float32, device="cuda")
    view = flat[offset:].view(a.shape)
    view.copy_(torch.from_numpy(a))
    return view


def _fwd_check(lead, glead, n, b, d, want_load, offset=0, seed=0):
    """The forward on the card against its plain version: an isolated row
    (exact zeros), a row whose denominator is negative, and a masked
    infinite score (a NaN row), at every layout and load path."""
    rng = np.random.default_rng(seed)
    x = np.clip(rng.standard_normal(lead + (n, b)), -3.5, 3.5).astype(np.float32)
    m = (rng.random(glead + (n, b)) < 0.7).astype(np.float32)
    m[..., 0] = 1.0
    iso, neg, nan = 5 % n, 9 % n, 11 % n
    x[..., neg, :], m[..., neg, :] = -6.0, 1.0
    m[..., iso, :] = 0.0
    if n > 11:
        x[..., nan, b - 1], m[..., nan, b - 1] = np.inf, 0.0
    h = rng.standard_normal(glead + (n, b, d)).astype(np.float32) * m[..., None]
    args = [_offset_tensor(a, offset) for a in (x, h, m)] + [torch.from_numpy(ATT16).cuda()]
    mod = importlib.import_module("repro_torch.kernels.cheb_attn")
    heads = x.shape[-3] if x.ndim >= 3 else 1
    plan = mod.launch_plan(heads, b, d, mod._aligned(*args[:3]))
    assert plan["load"] == want_load
    before = cheb_attn.launches
    got = cheb_attn(*args)
    torch.cuda.synchronize()
    assert cheb_attn.launches == before + 1
    want = cheb_attn_ref(*args)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5, equal_nan=True)
    assert (got[..., iso, :] == 0).all()
    assert (want[..., neg, :].abs().sum(-1) > 0).all()
    if n > 11:
        assert torch.isnan(got[..., nan, :]).all()
    return plan


FWD_CASES = {
    # name: (lead, glead, n, b, d, offset, load)
    "serve-tma": ((8,), (), 4099, 16, 16, 0, "tma"),             # N not a multiple of the tile
    "n-below-tile": ((8,), (), 5, 16, 16, 0, "tma"),
    "bucket-b8": ((8,), (), 1001, 8, 16, 0, "tma"),
    "misaligned-base": ((8,), (), 1001, 16, 16, 1, "cp.async"),
    "b-not-4": ((3,), (), 777, 5, 300, 0, "cp.async"),
    "b24-d48": ((8,), (), 1001, 24, 48, 0, "tma"),
    "2d": ((), (), 1001, 16, 16, 0, "tma"),
    "2d-misaligned": ((), (), 1001, 12, 20, 2, "cp.async"),
    "4d": ((3, 4), (3,), 517, 8, 40, 0, "tma"),
    "4d-b-not-4": ((2, 3), (2,), 300, 7, 9, 0, "cp.async"),
    "hb-16x64": ((16,), (), 300, 64, 128, 0, "tma"),
    "d1": ((8,), (), 777, 8, 1, 0, "tma"),
    "b1": ((8,), (), 777, 1, 16, 0, "cp.async"),
    "b32": ((4,), (), 500, 32, 8, 0, "tma"),
    "d-chunks": ((8,), (), 40, 16, 4096, 0, "cp.async"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FWD_CASES), ids=list(FWD_CASES))
def test_cuda_forward_load_paths_layouts_and_tile_edges(case):
    """Both load paths (TMA bulk copies; cp.async for B not a multiple of 4,
    a base that is not 16-byte aligned, or D cut into chunks), N around and
    below the node tile, the 2-d, 3-d and 4-d layouts with G > 1, B a power
    of two (the shuffle path) or not, and H*B up to 16*64."""
    _need_card()
    lead, glead, n, b, d, offset, load = FWD_CASES[case]
    plan = _fwd_check(lead, glead, n, b, d, load, offset)
    if case == "d-chunks":
        assert plan["d_chunk"] < d


@pytest.mark.cuda
def test_cuda_forward_raises_for_a_tensor_it_cannot_take():
    """No fallback: a strided input raises and counts no launch."""
    _need_card()
    x, h, m = (torch.from_numpy(a).cuda() for a in _inputs((8,), (), 64, 16, 16))
    before = cheb_attn.launches
    with pytest.raises(ValueError, match="contiguous"):
        cheb_attn(x[:, :, ::2], h[:, ::2], m[:, ::2], torch.from_numpy(ATT16).cuda())
    assert cheb_attn.launches == before


# ---------------------------------------------------------------------------
# poly_attn: tile edges, head dims, load paths
# ---------------------------------------------------------------------------

POLY_S = [1, 63, 65, 129, 300]
POLY_HD = [24, 64, 100, 128, 256]


def _poly_check(shape, dtype, causal, sign, want_load=None, offset=0):
    """poly_attn on the card against its plain version (float32 at the
    reference tests' 5e-4, bf16 at SEQ_TOL); with ``offset`` q, k and v
    start that many elements into their storage."""
    q, k, v = (_randn((int(np.prod(shape)) + offset,), seed, dtype)[offset:].view(shape)
               for seed in range(3))
    a1, a2 = (_randn(shape[1:2] + shape[3:], seed, scale=shape[3] ** -0.5) for seed in (3, 4))
    coeffs = torch.from_numpy(sign * attention_series(8, (-4.0, 4.0))).float().cuda()
    mod = importlib.import_module("repro_torch.kernels.poly_attn")
    plan = mod.launch_plan(shape[2], shape[3], dtype, mod._alignment(k, v))
    if want_load is not None:
        assert plan["load"] == want_load
    before = poly_attn.launches
    got = poly_attn(q, k, v, a1, a2, coeffs, causal=causal)
    torch.cuda.synchronize()
    assert poly_attn.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = poly_attn_plain(q, k, v, a1, a2, coeffs, causal=causal)
    tol = SEQ_TOL[dtype] if dtype == torch.bfloat16 else dict(rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    return plan


@pytest.mark.cuda
@pytest.mark.parametrize("s", POLY_S)
@pytest.mark.parametrize("hd", POLY_HD)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_cuda_poly_attn_tile_edges_and_head_dims(s, hd, dtype, causal):
    """Ragged S around the 32- and 64-key tiles and the 128- and 256-row
    blocks, hd 24, 64, 100, 128 and 256 (bf16 hd 100 takes cp.async, the
    rest TMA); the negated series on odd S, so that those rows' denominators
    are negative."""
    _need_card()
    size = 2 if dtype == torch.bfloat16 else 4
    _poly_check((2, 3, s, hd), dtype, causal, -1.0 if s % 2 else 1.0,
                "tma" if (hd * size) % 16 == 0 else "cp.async")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd,offset,copy_bytes", [
    (torch.float32, 64, 1, 4), (torch.float32, 100, 3, 4), (torch.bfloat16, 64, 2, 4),
    (torch.bfloat16, 7, 0, 2), (torch.bfloat16, 64, 1, 2), (torch.bfloat16, 130, 0, 4),
], ids=["f32-4B-aligned", "f32-hd100-4B", "bf16-4B-aligned", "bf16-odd-hd", "bf16-2B-aligned",
        "bf16-hd130"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["series", "negated"])
def test_cuda_poly_attn_cp_async_path(dtype, hd, offset, copy_bytes, causal, sign):
    """Bases that TMA cannot take (not 16-byte aligned) and rows that are not
    16-byte multiples go through cp.async, zero-filled past S and hd."""
    _need_card()
    plan = _poly_check((2, 2, 97, hd), dtype, causal, sign, "cp.async", offset)
    assert plan["copy_bytes"] == copy_bytes


@pytest.mark.cuda
def test_cuda_poly_attn_raises_for_a_tensor_it_cannot_take():
    """No fallback: a strided input raises, and no launch is counted."""
    _need_card()
    q = _randn((1, 2, 32, 128), 0)[..., :64]
    a = _randn((2, 64), 1)
    before = poly_attn.launches
    with pytest.raises(ValueError, match="contiguous"):
        poly_attn(q, q, q, a, a, torch.ones(3, device="cuda"))
    assert poly_attn.launches == before


# ---------------------------------------------------------------------------
# The pack engines (matrix, vector) on the card: plain float32 PyTorch, no
# kernel. Tolerances: tests/test_fedgat_engines.py:110 and :121.
# ---------------------------------------------------------------------------

PACK_LAYER_TOL = {"matrix": dict(rtol=1e-3, atol=1e-4), "vector": dict(rtol=1e-4, atol=1e-5)}


def _pack_case(graph, engine):
    from repro_torch.core import get_engine, init_params
    from repro_torch.core.fedgat_model import graph_tensors
    from repro_torch.graphs import make_sbm

    torch.backends.cuda.matmul.allow_tf32 = False
    g = make_cora_like("tiny", seed=0) if graph == "tiny" else make_sbm("sbm_1k", seed=0)
    cfg = FedGATConfig(engine=engine)
    params = init_params(torch.Generator().manual_seed(0), g.feature_dim, g.num_classes, cfg,
                         device="cpu")
    coeffs = torch.as_tensor(cfg.coeffs(), dtype=torch.float32)
    return g, cfg, get_engine(engine)(cfg), params, coeffs, graph_tensors(g, torch.device("cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("graph", ["tiny", "sbm1k"])
@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_cuda_pack_engines_match_the_cpu(graph, engine):
    """A pack built on the CPU and moved to the card serves the CPU's logits;
    a pack drawn on the card serves the direct engine's."""
    _need_card()
    from repro_torch.core import get_engine, layered_forward, pack_from_numpy

    g, cfg, eng, params, coeffs, arrays = _pack_case(graph, engine)
    pack = eng.precompute(torch.Generator().manual_seed(1), *arrays)
    want = layered_forward(eng, params, coeffs, pack, *arrays).detach()
    dev = torch.device("cuda")
    dparams = copy.deepcopy(params).to(dev)
    darrays = [a.to(dev) for a in arrays]
    before = (cheb_attn.launches, cheb_attn_backward.launches)
    got = layered_forward(eng, dparams, coeffs.to(dev), pack_from_numpy(pack, device=dev),
                          *darrays)
    torch.testing.assert_close(got.detach().cpu(), want, **PACK_LAYER_TOL[engine])
    drawn = eng.precompute(torch.Generator(device=dev).manual_seed(1), *darrays)
    again = eng.precompute(torch.Generator(device=dev).manual_seed(1), *darrays)
    assert all(torch.equal(a, b) for a, b in zip(drawn, again) if isinstance(a, torch.Tensor))
    on_card = layered_forward(eng, dparams, coeffs.to(dev), drawn, *darrays)
    direct = layered_forward(get_engine("direct")(cfg), dparams, coeffs.to(dev), None, *darrays)
    torch.cuda.synchronize()
    torch.testing.assert_close(on_card, direct, **PACK_LAYER_TOL[engine])
    assert (cheb_attn.launches, cheb_attn_backward.launches) == before   # no kernel on this path


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_cuda_pack_cache_saves_on_the_cpu_and_loads_onto_the_card(engine, tmp_path):
    _need_card()
    from repro_torch.serving import GraphDelta, GraphInferenceServer, PackCache, Query

    g, cfg, _, params, _, _ = _pack_case("tiny", engine)
    cpu = GraphInferenceServer(params, cfg, g, num_clients=2, device="cpu")
    qs = [Query(c, v) for c in (0, 1) for v in range(g.num_nodes)]
    cpu.serve_batch(qs)
    cpu.apply_update(GraphDelta(features=g.features[:2] + 0.01,
                                edges=np.array([[g.num_nodes, 3], [g.num_nodes + 1, 9], [0, 7]])))
    cpu.save_cache(str(tmp_path))
    cache = PackCache.load(str(tmp_path), device="cuda")
    for c in (0, 1):
        for a, b in zip(cache.peek(c).pack, cpu.cache.peek(c).pack):
            if isinstance(a, torch.Tensor):
                assert a.is_cuda and torch.equal(a.cpu(), b)
    card = GraphInferenceServer(params, cfg, cpu.graph, num_clients=2, device="cuda",
                                cache_dir=str(tmp_path))
    qs = [Query(c, v) for c in (0, 1) for v in range(cpu.graph.num_nodes)]
    got = np.stack([r.logits for r in card.serve_batch(qs)])
    assert card.cache.misses == cache.misses                # warm: no pack rebuilt
    want = np.stack([r.logits for r in cpu.serve_batch(qs)])
    np.testing.assert_allclose(got, want, **PACK_LAYER_TOL[engine])


@pytest.mark.cuda
def test_cuda_refresh_rebuilds_bit_for_bit():
    _need_card()
    from repro_torch.serving import GraphDelta, GraphInferenceServer, Query

    g, cfg, _, params, _, _ = _pack_case("sbm1k", "matrix")
    server = GraphInferenceServer(params, cfg, g, num_clients=2, device="cuda",
                                  refresh_threshold=1e9)
    server.serve_batch([Query(0, 0), Query(1, 0)])
    rep = server.apply_update(GraphDelta(features=g.features[:4],
                                         edges=np.array([[g.num_nodes + i, i] for i in range(4)])))
    assert rep["refreshed"] == [] and server.cache.stats()["patches"] == 2
    server.refresh(0)
    fresh = server.engine.precompute(server._client_gen(0), server._h, server._idx, server._mask)
    assert all(torch.equal(a, b) for a, b in zip(server.pack_for(0), fresh)
               if isinstance(a, torch.Tensor))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_cuda_pack_engine_training_matches_cpu_training(engine):
    """The same pack (built on the CPU, moved over) trains on the card as on
    the CPU: curves to 1e-6, params at the reference's gradient tolerance."""
    _need_card()
    from repro_torch.core import FedGAT
    from repro_torch.federated.trainer import pack_generator

    torch.backends.cuda.matmul.allow_tf32 = False
    g = make_cora_like("tiny", seed=0)
    cfg = FederatedConfig(num_clients=4, rounds=2, local_steps=2,
                          model=FedGATConfig(engine=engine))
    pack = FedGAT(cfg.model, device="cpu").precommunicate(pack_generator(0, "cpu"), g)
    before = (cheb_attn.launches, cheb_attn_backward.launches)
    gpu = run_federated(g, cfg, device="cuda", pack=pack)
    assert (cheb_attn.launches, cheb_attn_backward.launches) == before
    cpu = run_federated(g, cfg, device="cpu", pack=pack)
    np.testing.assert_allclose(gpu["val_curve"], cpu["val_curve"], atol=1e-6)
    np.testing.assert_allclose(gpu["test_curve"], cpu["test_curve"], atol=1e-6)
    for a, b in zip(gpu["params"].parameters(), cpu["params"].parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# Cohort streaming and the privacy stack on the card
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


def _small_trees(device):
    gen = torch.Generator().manual_seed(3)
    return [{"W": torch.randn(6, 5, generator=gen).to(device),
             "a": torch.randn(5, generator=gen).to(device)}]


@pytest.mark.cuda
def test_cuda_dp_noise_and_pairwise_masks_equal_the_cpus():
    _needs_card()
    from repro_torch.privacy import (PrivacyConfig, add_client_mask, make_dp_transform,
                                     mask_base_key, tree_add_normal)

    cpu, gpu = _small_trees("cpu"), _small_trees("cuda")
    noised = tree_add_normal(17, gpu, 0.3)
    assert noised[0]["W"].is_cuda
    want = tree_add_normal(17, cpu, 0.3)
    for k in ("W", "a"):
        assert torch.equal(noised[0][k].cpu(), want[0][k])
    dp = make_dp_transform(PrivacyConfig(clip=0.5, noise_multiplier=0.8), 4)
    local_cpu = [{k: v * 2.0 for k, v in cpu[0].items()}]
    local_gpu = [{k: v * 2.0 for k, v in gpu[0].items()}]
    got, want = dp(5, gpu, local_gpu), dp(5, cpu, local_cpu)
    for k in ("W", "a"):
        torch.testing.assert_close(got[0][k].cpu(), want[0][k], rtol=1e-6, atol=1e-6)
    sel = np.array([1, 1, 0, 1], np.float32)
    masked = [add_client_mask(mask_base_key(0), 2, c, sel, gpu, 1.0) for c in (0, 1, 3)]
    assert masked[0][0]["W"].is_cuda
    want = add_client_mask(mask_base_key(0), 2, 1, sel, cpu, 1.0)
    assert torch.equal(masked[1][0]["W"].cpu(), want[0]["W"])
    total = sum(m[0]["W"] for m in masked) - 3 * gpu[0]["W"]
    torch.testing.assert_close(total, torch.zeros_like(total), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_cuda_noisy_pack_draws_on_the_card(engine):
    _needs_card()
    from repro_torch.core import FedGAT
    from repro_torch.graphs import make_sbm
    from repro_torch.privacy import noisy_pack, pack_noise_key, pack_sensitivities

    g = make_sbm("sbm_1k", seed=0)
    pack = FedGAT(FedGATConfig(engine=engine), device="cuda").precommunicate(
        torch.Generator(device="cuda").manual_seed(0), g)
    sens = pack_sensitivities(pack, g.features)
    a = noisy_pack(pack_noise_key(0), pack, g.features, 0.5)
    b = noisy_pack(pack_noise_key(0), pack, g.features, 0.5)
    for name in pack._fields:
        clean, got = getattr(pack, name), getattr(a, name)
        if name not in sens:
            assert got is clean
            continue
        assert got.is_cuda and torch.equal(got, getattr(b, name))
        std = float((got - clean).double().std())
        assert abs(std - 0.5 * sens[name]) < 0.05 * 0.5 * sens[name], name


@pytest.mark.cuda
@pytest.mark.parametrize("priv", [
    dict(clip=1.0, noise_multiplier=0.5),
    dict(secure_agg=True, secure_agg_mode="pairwise", clip=1.0),
    dict(secure_agg=True),
], ids=["dp", "pairwise", "protocol"])
def test_cuda_cohort_training_matches_cpu_training(priv):
    _needs_card()
    from repro_torch.privacy import PrivacyConfig

    g = make_cora_like("tiny", seed=0)
    cfg = FederatedConfig(num_clients=6, rounds=2, local_steps=2, client_fraction=0.5,
                          max_concurrent_clients=2, model=FedGATConfig(engine="kernel"),
                          privacy=PrivacyConfig(**priv))
    before = cheb_attn_backward.launches
    on_gpu = run_federated(g, cfg, device="cuda")
    assert cheb_attn_backward.launches - before == 2 * 3 * 2
    on_cpu = run_federated(g, cfg, device="cpu")
    np.testing.assert_allclose(on_gpu["val_curve"], on_cpu["val_curve"], atol=1e-6)
    np.testing.assert_allclose(on_gpu["test_curve"], on_cpu["test_curve"], atol=1e-6)
    # The output layer's a1 reaches the logits only through the leaky
    # ReLU's kink: on tiny its gradient is rounding noise that Adam scales
    # into steps (tests/test_torch_federated.py), so it is not held.
    for (name, a), b in zip(on_gpu["params"].named_parameters(), on_cpu["params"].parameters()):
        if name != "1.a1":
            torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-3, atol=1e-4)
    assert on_gpu["epsilon"] == on_cpu["epsilon"] and on_gpu["cohort"] == on_cpu["cohort"]


@pytest.mark.cuda
def test_cuda_one_lane_shard_map_matches_the_loop():
    _needs_card()
    g = make_cora_like("tiny", seed=0)
    cfg = FederatedConfig(num_clients=4, rounds=2, local_steps=2,
                          model=FedGATConfig(engine="kernel", degree=10))
    before = (cheb_attn.launches, cheb_attn_backward.launches)
    shard = run_federated(g, cfg, backend="shard_map", device="cuda")
    launches = (cheb_attn.launches - before[0], cheb_attn_backward.launches - before[1])
    loop = run_federated(g, cfg, device="cuda")
    assert launches == (2 * (4 * 2 + 1), 2 * 4 * 2)
    assert shard["mesh"] == {"axis_names": ["lanes"], "axis_sizes": [1], "num_devices": 1,
                             "num_processes": 1, "platform": "gpu"}
    assert shard["cohort"]["lanes"] == 1
    np.testing.assert_allclose(shard["val_curve"], loop["val_curve"], atol=1e-6)
    np.testing.assert_allclose(shard["test_curve"], loop["test_curve"], atol=1e-6)
    for (name, a), b in zip(shard["params"].named_parameters(), loop["params"].parameters()):
        if name != "1.a1":      # rounding noise that Adam carries (see above)
            torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-3, atol=1e-4)


RANK_WORKER = r"""
import json, sys
import torch
from repro_torch.launch import multiprocess as mp
rank, nproc, collectives = mp.initialize_worker(device="cuda")
import torch.distributed as dist
from repro_torch.core import FedGATConfig
from repro_torch.federated import FederatedConfig, run_federated
from repro_torch.federated.trainer import param_tree
from repro_torch.graphs import make_cora_like
from repro_torch.kernels.cheb_attn import cheb_attn, cheb_attn_backward
try:
    cfg = FederatedConfig(num_clients=4, rounds=2, local_steps=2,
                          model=FedGATConfig(engine="kernel", degree=10))
    res = run_federated(make_cora_like("tiny", seed=0), cfg, backend="shard_map")
    torch.save({"collectives": collectives, "device": str(torch.cuda.current_device()),
                "launches": (cheb_attn.launches, cheb_attn_backward.launches),
                "val_curve": res["val_curve"], "test_curve": res["test_curve"],
                "mesh": res["mesh"],
                "params": [{k: v.cpu() for k, v in layer.items()}
                           for layer in param_tree(res["params"])]},
               f"{sys.argv[1]}/rank{rank}.pt")
finally:
    dist.destroy_process_group()
"""


def _two_cuda_ranks(tmp_path, env):
    """RANK_WORKER on two ranks against the loop on the card: curves,
    params but the output layer's a1, launches per rank, bit-identical
    ranks."""
    from repro_torch.launch import multiprocess as mp

    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = {**os.environ, **env, "PYTHONPATH": src + os.pathsep + os.environ.get("PYTHONPATH", "")}
    code = mp.launch([sys.executable, "-c", RANK_WORKER, str(tmp_path)], processes=2,
                     devices_per_process=2, timeout=300, env=env)
    assert code == 0
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    g = make_cora_like("tiny", seed=0)
    loop = run_federated(g, FederatedConfig(num_clients=4, rounds=2, local_steps=2,
                                            model=FedGATConfig(engine="kernel", degree=10)),
                         device="cuda")
    assert ranks[0]["launches"] == (2 * (2 * 2 + 1), 2 * 2 * 2)     # rank 0 evaluates
    assert ranks[1]["launches"] == (2 * 2 * 2, 2 * 2 * 2)
    assert ranks[0]["mesh"]["platform"] == "gpu" and ranks[0]["mesh"]["num_processes"] == 2
    np.testing.assert_allclose(ranks[0]["val_curve"], loop["val_curve"], atol=1e-6)
    np.testing.assert_allclose(ranks[0]["test_curve"], loop["test_curve"], atol=1e-6)
    for li, (l0, l1) in enumerate(zip(ranks[0]["params"], ranks[1]["params"])):
        for k in l0:
            assert torch.equal(l0[k], l1[k])
            if (li, k) != (1, "a1"):
                torch.testing.assert_close(l0[k], loop["params"][li][k].detach().cpu(),
                                           rtol=1e-3, atol=1e-4)
    return ranks


@pytest.mark.cuda
def test_cuda_two_gloo_ranks_share_the_card(tmp_path):
    _needs_card()
    ranks = _two_cuda_ranks(tmp_path, {"CUDA_VISIBLE_DEVICES": "0"})
    assert [r["collectives"] for r in ranks] == ["gloo", "gloo"]
    assert [r["device"] for r in ranks] == ["0", "0"]


@pytest.mark.cuda
def test_cuda_two_nccl_ranks_a_card_each(tmp_path):
    _needs_card()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    ranks = _two_cuda_ranks(tmp_path, {})
    assert [r["collectives"] for r in ranks] == ["nccl", "nccl"]
    assert [r["device"] for r in ranks] == ["0", "1"]


# -- the language-model substrate (plain PyTorch: no kernel on this path) ----

def _lm_counts():
    return (cheb_attn.launches, cheb_attn_backward.launches, flash_attn.launches,
            poly_attn.launches, wkv_chunked.launches)


def _lm_inputs(cfg, device, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["prefix"] = rng.standard_normal((B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["frames"] = rng.standard_normal((B, S // cfg.encoder_ratio, cfg.d_model)).astype(
            np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def _lm_leaves(obj, prefix=""):
    if obj is None:
        return {}
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    items = (obj.items() if isinstance(obj, dict) else
             zip(obj._fields, obj) if hasattr(obj, "_fields") else enumerate(obj))
    out = {}
    for k, v in items:
        out.update(_lm_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _lm_close(got, want, rtol, atol):
    g, w = _lm_leaves(got), _lm_leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a = g[k].detach().cpu()
        assert a.dtype == w[k].dtype, k
        torch.testing.assert_close(a, w[k].detach(), rtol=rtol, atol=atol, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["chatglm3-6b", "hymba-1.5b", "yi-6b", "rwkv6-1.6b",
                                  "paligemma-3b", "seamless-m4t-large-v2",
                                  "granite-moe-1b-a400m", "dbrx-132b", "qwen2-72b",
                                  "minitron-8b"])
def test_cuda_lm_arch_matches_the_cpu(arch):
    """A reduced arch on the card against the CPU (params drawn once on the
    CPU): forward through prefill and one decode step at rtol 1e-4 / atol
    1e-5, the loss too and the grads at rtol 1e-3; no kernel launched."""
    _needs_card()
    from repro_torch._tree import tree_map
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import build_model

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    before = _lm_counts()
    out = {}
    for name, params, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        b = _lm_inputs(cfg, dev)
        pb = {k: v for k, v in b.items() if k != "labels"}
        pb["tokens"], pb["cache_len"] = b["tokens"][:, :15], 32
        with torch.no_grad():
            logits, cache = model.prefill(params, pb)
            step = model.decode_step(params, cache, b["tokens"][:, 15:])
        out[name] = ((logits, cache), step, value_and_grad(model.loss, params, b))
    assert _lm_counts() == before
    (pf, dec, (loss, parts, grads)) = out["card"]
    (pf_c, dec_c, (loss_c, parts_c, grads_c)) = out["cpu"]
    _lm_close(pf, pf_c, 1e-4, 1e-5)
    _lm_close(dec, dec_c, 1e-4, 1e-5)
    _lm_close((loss, parts), (loss_c, parts_c), 1e-4, 1e-5)
    _lm_close(grads, grads_c, 1e-3, 1e-5)


@pytest.mark.cuda
def test_cuda_lm_bf16_serve_and_train_step():
    """A bf16 reduced config served and stepped on the card: finite logits,
    tokens inside the vocab, every param float32 after one step."""
    _needs_card()
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.steps import adam_init_f32, make_train_step
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    assert all(t.dtype == torch.bfloat16 and t.is_cuda for t in _lm_leaves(params).values())
    b = _lm_inputs(cfg, "cuda", B=4, S=32)
    before = _lm_counts()
    res = serve_lm(model, params, {"tokens": b["tokens"]}, 8, 48)
    new, opt, loss = make_train_step(cfg)(params, adam_init_f32(params), b)
    assert _lm_counts() == before
    assert bool(torch.isfinite(res["prefill_logits"]).all()) and res["tokens"].shape == (4, 8)
    assert 0 <= int(res["tokens"].min()) and int(res["tokens"].max()) < cfg.vocab_size
    assert bool(torch.isfinite(loss)) and int(opt.step) == 1
    assert {t.dtype for t in _lm_leaves(new).values()} == {torch.float32}
