"""The CUDA kernels against their plain versions, and a short federated
training run on the card against the same run on the CPU.

Tolerances: cheb_attn as ``chip_smoke.py``; the sequence kernels at the
reference tests' own (``tests/test_kernels.py``: flash f32 2e-4/2e-5, bf16
2e-2; poly 5e-4; wkv 1e-4).

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.
"""
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


@pytest.mark.cuda
@pytest.mark.parametrize("bh,s,hd,chunk", [(3, 50, 24, 10), (2, 64, 128, 16), (4, 128, 64, 16),
                                           (2, 96, 64, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_wkv_chunked_matches_plain_version_and_scan(bh, s, hd, chunk, dtype):
    _need_card()
    r, k, v = (_randn((bh, s, hd), seed, dtype) for seed in range(3))
    w = (torch.sigmoid(_randn((bh, s, hd), 3) + 1.0) * 0.99).to(dtype)
    u = _randn((hd,), 4, scale=0.1)
    S0 = _randn((bh, hd, hd), 5, scale=0.1)
    before = wkv_chunked.launches
    y, sf = wkv_chunked(r, k, v, w, u, S0, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_chunked.launches == before + 1
    assert y.dtype == sf.dtype == torch.float32
    for want in (wkv_chunked_plain(r, k, v, w, u, S0, chunk=chunk), wkv_ref(r, k, v, w, u, S0)):
        torch.testing.assert_close(y, want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(sf, want[1], rtol=1e-4, atol=1e-4)


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
