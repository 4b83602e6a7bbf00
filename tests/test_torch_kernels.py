"""repro_torch's cheb_attn and its gradients against the JAX package.

On the CPU the wrapper runs its plain versions (forward and backward); the
JAX side runs its Pallas kernel in interpret mode, its jnp oracle, and
``jax.vjp`` of its differentiable entry ``cheb_attn_diff``. The CUDA
kernels themselves are held against the plain versions by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``, which skips without
a card.
"""
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax

from repro.core.chebyshev import attention_series
from repro.kernels import ref as jref
from repro.kernels.cheb_attn import cheb_attn as jax_cheb_attn
from repro.kernels.cheb_attn import cheb_attn_diff as jax_cheb_attn_diff
from repro_torch.core import FedGATConfig, get_engine, init_params, layered_forward
from repro_torch.graphs import make_cora_like
from repro_torch.kernels import _build
from repro_torch.kernels.cheb_attn import (
    MAX_COEFFS,
    _bwd_ld,
    wave_grid,
    backward_launch_config,
    cheb_attn,
    cheb_attn_backward,
)
from repro_torch.kernels.ref import cheb_attn_bwd_ref, cheb_attn_ref

cheb_mod = importlib.import_module("repro_torch.kernels.cheb_attn")
gather_mod = importlib.import_module("repro_torch.kernels.nbr_gather")

torch.set_num_threads(1)

ATT16 = attention_series(16, (-4.0, 4.0)).astype(np.float32)
RTOL, ATOL = 1e-4, 5e-5          # tests/test_kernel_engine.py:149
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4  # tests/test_kernel_engine.py:275-276


def _inputs(layout, seed=0, n=32, b=8, d=24, heads=3, graphs=2):
    rng = np.random.default_rng(seed)
    lead = {"2d": (), "3d": (heads,), "4d": (graphs, heads)}[layout]
    glead = (graphs,) if layout == "4d" else ()
    x = np.clip(rng.standard_normal(lead + (n, b)), -3.5, 3.5).astype(np.float32)
    h = rng.standard_normal(glead + (n, b, d)).astype(np.float32)
    m = (rng.random(glead + (n, b)) < 0.7).astype(np.float32)
    m[..., 0] = 1.0
    m[..., 5, :] = 0.0                          # an isolated row
    h = h * m[..., None]
    return x, h, m


def _port(x, h, m, coeffs=ATT16):
    return cheb_attn(*(torch.from_numpy(a) for a in (x, h, m, coeffs))).numpy()


@pytest.mark.parametrize("layout", ["2d", "3d", "4d"])
def test_plain_cheb_attn_matches_jax_kernel_and_oracle(layout):
    x, h, m = _inputs(layout)
    got = _port(x, h, m)
    want = np.asarray(jax_cheb_attn(
        jnp.asarray(x), jnp.asarray(h), jnp.asarray(m), jnp.asarray(ATT16),
        block_n=16, block_d=8, interpret=True,
    ))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if layout == "4d":       # the jnp oracle takes one graph at a time
        for g in range(x.shape[0]):
            oracle = np.asarray(jref.cheb_attn_ref(x[g], h[g], m[g], ATT16))
            np.testing.assert_allclose(got[g], oracle, rtol=RTOL, atol=ATOL)
    else:
        oracle = np.asarray(jref.cheb_attn_ref(x, h, m, ATT16))
        np.testing.assert_allclose(got, oracle, rtol=RTOL, atol=ATOL)
    iso = got[..., 5, :]
    assert np.isfinite(got).all() and (iso == 0.0).all()


def test_fully_masked_input_gives_exact_zeros():
    x, h, _ = _inputs("3d", seed=1)
    out = _port(x, h, np.zeros(x.shape[1:], np.float32))
    assert (out == 0.0).all() and not np.signbit(out).any()


def test_negative_denominator_divides_like_reference():
    """Out of the fitted domain the degree-16 series goes negative; such a
    row's denominator is negative and nonzero, and it divides."""
    x, h, m = _inputs("3d", seed=2)
    x[:, 7, :] = -6.0
    m[7, :] = 1.0
    e = np.polyval(ATT16[::-1].astype(np.float64), -6.0)
    assert e < 0
    got = _port(x, h, m)
    want = np.asarray(jref.cheb_attn_ref(x, h, m, ATT16))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[:, 7], np.broadcast_to(h[7].mean(0), got[:, 7].shape),
                               rtol=RTOL, atol=ATOL)


def test_nan_from_masked_infinite_score_propagates():
    """The mask multiplies after Horner, so an infinite score in a masked
    slot gives NaN, as in the reference."""
    x, h, m = _inputs("2d", seed=3)
    x[4, 3], m[4, 3] = np.inf, 0.0
    got = _port(x, h, m)
    want = np.asarray(jref.cheb_attn_ref(x, h, m, ATT16))
    assert np.isnan(got[4]).all() and np.isnan(want[4]).all()
    np.testing.assert_allclose(np.delete(got, 4, 0), np.delete(want, 4, 0), rtol=RTOL, atol=ATOL)


FWD_SHAPES = [(8, 16, 16), (8, 8, 16), (8, 24, 48), (1, 8, 1), (3, 5, 300), (16, 64, 128),
              (8, 16, 4096)]


@pytest.mark.parametrize("heads,b,d", FWD_SHAPES)
def test_forward_launch_plan_follows_the_size_formula(heads, b, d):
    """The shared memory is fwd_smem_bytes of csrc/cheb_attn.cu: 128 bytes of
    barriers, the coefficients, each consumer warp's weights (H rows at the
    odd stride B | 1) and denominators, and two stages of H score segments
    (a node row apart), the mask span and the neighbour rows; the tile is
    the largest power of two up to 32 whose stage fits 32 KB, with one
    consumer warp per node up to 8, plus the producer warp."""
    plan = cheb_mod.launch_plan(heads, b, d, aligned=True)

    def r4(n):
        return -(-n // 4) * 4

    def stage(tile, dc):
        return 4 * (heads * r4((tile + 1) * b) + r4(tile * b) + r4(tile * b * dc))

    tile, dc, warps = plan["tile"], plan["d_chunk"], plan["warps"]
    assert plan["stages"] == 2
    assert plan["smem_bytes"] == (128 + 4 * MAX_COEFFS
                                  + 4 * warps * (r4(heads * (b | 1)) + r4(heads))
                                  + 2 * stage(tile, dc))
    assert plan["smem_bytes"] <= 227 * 1024
    assert tile in (1, 2, 4, 8, 16, 32) and warps == min(8, tile)
    assert plan["threads"] == 32 * (warps + 1)
    assert stage(tile, dc) <= 32 * 1024 or tile == 1
    assert tile == 32 or stage(2 * tile, d) > 32 * 1024


def test_forward_launch_plan_serves_sbm_1m_in_tiles_of_16_nodes():
    """The serving shape (H8 B16 D16) and the bucketed layer's buckets (B 16
    and 8) take the TMA path, with three blocks' stages fitting an SM."""
    serve = cheb_mod.launch_plan(8, 16, 16, aligned=True)
    assert (serve["tile"], serve["warps"], serve["load"]) == (16, 8, "tma")
    assert 3 * (serve["smem_bytes"] + 1024) <= 228 * 1024
    cap8 = cheb_mod.launch_plan(8, 8, 16, aligned=True)
    assert (cap8["tile"], cap8["load"]) == (32, "tma")


@pytest.mark.parametrize("b,aligned,load", [
    (16, True, "tma"), (8, True, "tma"), (16, False, "cp.async"), (24, True, "tma"),
    (5, True, "cp.async"), (6, True, "cp.async"),
])
def test_forward_launch_plan_takes_tma_exactly_when_bulk_copies_can(b, aligned, load):
    """1-D bulk copies need 16-byte-aligned addresses and sizes: every base
    pointer aligned and B a multiple of 4 (then the score, mask and
    neighbour spans of any node tile are too), and D in one chunk."""
    assert cheb_mod.launch_plan(3, b, 16, aligned)["load"] == load


def test_forward_launch_plan_cuts_a_wide_d_into_chunks():
    """A node whose neighbour tile does not fit two stages goes one node at a
    time, D cut into the widest chunk that fits (a multiple of 4), on the
    cp.async path."""
    plan = cheb_mod.launch_plan(8, 16, 4096, aligned=True)
    assert plan["tile"] == 1 and plan["warps"] == 1 and plan["load"] == "cp.async"
    assert plan["d_chunk"] < 4096 and plan["d_chunk"] % 4 == 0
    wider = cheb_mod.launch_plan(8, 16, plan["d_chunk"] + 4, aligned=True)
    assert wider["d_chunk"] <= plan["d_chunk"]
    assert cheb_mod.launch_plan(8, 16, plan["d_chunk"], aligned=True)["d_chunk"] == \
        plan["d_chunk"]


def test_forward_launch_plan_rejects_oversized_rows():
    with pytest.raises(ValueError, match="shared memory"):
        cheb_mod.launch_plan(64, 1024, 16, aligned=True)


def _meta(*arrays):
    return [torch.empty(a.shape, dtype=torch.float32, device="meta") for a in arrays]


def test_non_cpu_request_raises_when_the_library_cannot_load(monkeypatch):
    """No fallback to the plain version: a tensor off the CPU goes to the
    kernel, and a kernel that cannot be built raises."""
    def no_library(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cheb_mod, "_lib", None)
    monkeypatch.setattr(_build, "load_library", no_library)
    x, h, m = _inputs("3d")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cheb_attn(*_meta(x, h, m, ATT16))


def test_non_cuda_device_is_refused_by_the_wrapper(monkeypatch):
    monkeypatch.setattr(cheb_mod, "_lib", object())
    before = cheb_attn.launches
    x, h, m = _inputs("3d")
    with pytest.raises(ValueError, match="one CUDA device"):
        cheb_attn(*_meta(x, h, m, ATT16))
    assert cheb_attn.launches == before


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "never-built")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["cheb_attn"])
    assert _build.kernel_names() == [
        "cheb_attn", "flash_attn", "nbr_gather", "poly_attn", "wkv_chunk"]


@pytest.mark.parametrize("edit", ["header", "source", "new header"])
def test_library_path_hashes_every_header_with_the_source(monkeypatch, tmp_path, edit):
    """A library's name carries a digest of its source and of every header
    under csrc/ (flash_attn.cu and poly_attn.cu include attn_common.cuh), so
    editing a header rebuilds the libraries; checked in a copy of csrc/."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert (csrc / "attn_common.cuh").exists()
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    before = {name: _build.library_path(name) for name in _build.kernel_names()}
    assert {name: _build.library_path(name) for name in before} == before
    if edit == "header":
        with open(csrc / "attn_common.cuh", "a") as f:
            f.write("\n// an edit\n")
        changed = set(before)
    elif edit == "source":
        with open(csrc / "poly_attn.cu", "a") as f:
            f.write("\n// an edit\n")
        changed = {"poly_attn"}
    else:
        (csrc / "other.cuh").write_text("#pragma once\n")
        changed = set(before)
    after = {name: _build.library_path(name) for name in before}
    assert {name for name in before if after[name] != before[name]} == changed


# ---------------------------------------------------------------------------
# Gradients
# ---------------------------------------------------------------------------

def _grad_inputs(layout, case):
    x, h, m = _inputs(layout, seed=7)
    if case == "negative":
        x[..., 7, :] = -6.0                     # series < 0: negative denominator
        m[..., 7, :] = 1.0
    else:                                       # a masked infinite score
        x[..., 4, 3] = np.inf
        m[..., 4, 3] = 0.0
    dout = np.random.default_rng(8).standard_normal(x.shape[:-1] + h.shape[-1:]).astype(np.float32)
    return x, h, m, dout


def _jax_vjp(x, h, m, dout, coeffs=ATT16):
    def vjp(x, h, m, dout):
        out, f = jax.vjp(lambda *a: jax_cheb_attn_diff(*a, 16, 8, True),
                         jnp.asarray(x), jnp.asarray(h), jnp.asarray(m), jnp.asarray(coeffs))
        return [np.asarray(c) for c in f(jnp.asarray(dout))]

    if x.ndim < 4:
        return vjp(x, h, m, dout)
    per_graph = [vjp(*a) for a in zip(x, h, m, dout)]   # the diff entry takes one graph
    dx, dh, dm = (np.stack([c[i] for c in per_graph]) for i in range(3))
    return [dx, dh, dm, sum(c[3] for c in per_graph)]


def _port_grads(x, h, m, dout):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, h, m, ATT16)]
    out = cheb_attn(*leaves)
    return [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(dout))]


@pytest.mark.parametrize("case", ["negative", "nan"])
@pytest.mark.parametrize("layout", ["2d", "3d", "4d"])
def test_cheb_attn_gradients_match_jax_vjp_of_cheb_attn_diff(layout, case):
    """All four cotangents against the reference's training entry, with an
    isolated row (exact zeros), a negative-denominator row, and a masked
    infinite score (NaN, as the JAX vjp gives: inf * 0)."""
    x, h, m, dout = _grad_inputs(layout, case)
    got, want = _port_grads(x, h, m, dout), _jax_vjp(x, h, m, dout)
    for name, a, b in zip(("dx", "dh_nb", "dmask", "dcoeffs"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_allclose(a, b, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)
    node_axis = {"dx": -2, "dh_nb": -3, "dmask": -2}
    for name, a in zip(node_axis, got):
        assert (np.take(a, 5, axis=node_axis[name]) == 0.0).all(), name   # isolated row
    if case == "nan":
        assert np.isnan(got[0][..., 4, :]).all() and np.isnan(got[3]).all()
        assert np.isfinite(np.delete(got[0], 4, axis=-2)).all()
    else:
        assert np.isfinite(got[3]).all() and (got[0][..., 7, :] != 0).any()


# A quadratic with a negative minimum (p(-2) = -0.5): scores near -2 give
# negative denominators, and float32 keeps every cotangent to ~1e-6.
QUAD = np.array([0.5, 1.0, 0.25], np.float32)


def _factored_cotangents(x, h, m, coeffs, dout):
    """The backward kernel's algebra (csrc/cheb_attn.cu), in float64: with
    A = sum_d dout h_nb and c = sum_b e A / den (= sum_d dout out),
    g_e = (A - c) / den, 0 where den == 0; then dx, dmask and dcoeffs."""
    x4, h4, m4 = (torch.from_numpy(a).double() for a in _as_batched(x, h, m))
    d4 = torch.from_numpy(dout).double().reshape(x4.shape[:-1] + dout.shape[-1:])
    p, dp = torch.zeros_like(x4), torch.zeros_like(x4)
    for q in torch.from_numpy(coeffs).double().flip(0):
        dp = dp * x4 + p
        p = p * x4 + q
    mm = m4[:, None]
    e = p * mm
    den = e.sum(-1, keepdim=True)
    ok = den != 0
    a = torch.einsum("ghnd,gnbd->ghnb", d4, h4)
    c = torch.where(ok, (e * a).sum(-1, keepdim=True) / torch.where(ok, den, 1.0), 0.0)
    g_e = torch.where(ok, (a - c) / torch.where(ok, den, 1.0), 0.0)
    dx = (g_e * mm * dp).reshape(x.shape)
    dmask = (g_e * p).sum(1).reshape(m.shape)
    dcoeffs = torch.stack([(g_e * mm * x4**k).sum() for k in range(len(coeffs))])
    return [t.numpy() for t in (dx, dmask, dcoeffs)]


def _as_batched(x, h, m):
    if x.ndim == 2:
        return x[None, None], h[None], m[None]
    if x.ndim == 3:
        return x[None], h[None], m[None]
    return x, h, m


@pytest.mark.parametrize("layout", ["2d", "3d", "4d"])
def test_factored_g_e_matches_autograd_and_jax_vjp(layout):
    """The kernel never forms ``out``: it factors g_e through A and c. That
    algebra, in float64, against torch.autograd through the plain forward
    (float64) and jax.vjp of the reference's cheb_attn_diff (float32), with
    an isolated row (den == 0) and a row of negative denominators."""
    x, h, m, dout = _grad_inputs(layout, "negative")
    x[..., 7, :] = -2.0                         # p(-2) = -0.5 < 0 on every neighbour
    got = _factored_cotangents(x, h, m, QUAD, dout)
    assert (got[0][..., 5, :] == 0).all() and (got[1][..., 5, :] == 0).all()
    assert (np.take(x, 7, axis=-2) == -2.0).all()
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (x, m, QUAD)]
    out = cheb_attn_ref(leaves[0], torch.from_numpy(h).double(), leaves[1], leaves[2])
    auto = [g.numpy() for g in torch.autograd.grad(out, leaves, torch.from_numpy(dout).double())]
    jx = _jax_vjp(x, h, m, dout, QUAD)
    for name, a, b, c in zip(("dx", "dmask", "dcoeffs"), got, auto, (jx[0], jx[2], jx[3])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=f"{name} vs autograd")
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5, err_msg=f"{name} vs jax.vjp")


@pytest.mark.parametrize("layout", ["2d", "3d", "4d"])
def test_plain_backward_matches_autograd_through_the_plain_forward(layout):
    x, h, m, dout = _grad_inputs(layout, "negative")
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (x, h, m, ATT16)]
    want = torch.autograd.grad(cheb_attn_ref(*leaves), leaves, torch.from_numpy(dout).double())
    got = cheb_attn_bwd_ref(*(t.detach() for t in leaves), torch.from_numpy(dout).double())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-9)
    only_dx = cheb_attn_bwd_ref(*(t.detach() for t in leaves), torch.from_numpy(dout).double(),
                                (True, False, False, False))
    assert only_dx[1:] == (None, None, None)
    torch.testing.assert_close(only_dx[0], want[0], rtol=1e-9, atol=1e-9)


def test_gradients_flow_only_to_inputs_that_need_them():
    x, h, m, dout = _grad_inputs("3d", "negative")
    xt = torch.from_numpy(x).requires_grad_()
    out = cheb_attn(xt, torch.from_numpy(h), torch.from_numpy(m), torch.from_numpy(ATT16))
    (gx,) = torch.autograd.grad(out, xt, torch.from_numpy(dout))
    np.testing.assert_allclose(gx.numpy(), _jax_vjp(x, h, m, dout)[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_kernel_engine_gradients_match_the_direct_engine_with_features_needing_grad():
    """A 3-layer model whose input features need a gradient: the kernel
    engine's layer 1 then asks the Function for d h_nb as well as dx."""
    g = make_cora_like("tiny", seed=0)
    cfg = FedGATConfig(num_layers=3, degree=10)
    params = init_params(torch.Generator().manual_seed(2), g.feature_dim, g.num_classes, cfg,
                         device="cpu")
    coeffs = torch.tensor(cfg.coeffs(), dtype=torch.float32)
    idx, mask = torch.tensor(g.nbr_idx).long(), torch.tensor(g.nbr_mask)

    def grads(engine):
        h = torch.tensor(g.features).requires_grad_()
        out = layered_forward(get_engine(engine)(cfg), params, coeffs, None, h, idx, mask)
        leaves = [h, *params.parameters()]
        return torch.autograd.grad((out ** 2).sum(), leaves)

    for a, b in zip(grads("kernel"), grads("direct")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=5e-4)


def _bwd_per_warp(heads, b, dc):
    """Bytes of one warp's slice in csrc/cheb_attn.cu's backward."""
    def r4(n):
        return -(-n // 4) * 4

    ld = _bwd_ld(dc)
    floats = 5 * r4(heads * b) + r4(b) + r4(b * ld) + r4(heads * ld) + 2 * r4(heads)
    return 4 * (floats + MAX_COEFFS)


@pytest.mark.parametrize("heads,b,d", [(8, 16, 16), (8, 24, 48), (1, 8, 1), (3, 5, 300), (16, 64, 128)])
def test_backward_launch_config_fits_the_block(heads, b, d):
    """One warp per node: the slice formula of csrc/cheb_attn.cu, at most 8
    warps, within the default 48 KB, and D cut into chunks only when the
    whole tile does not fit (the (16, 64, 128) case)."""
    warps, d_chunk, smem = backward_launch_config(heads, b, d)
    per_warp = _bwd_per_warp(heads, b, d_chunk)
    assert 1 <= warps <= 8 and 1 <= d_chunk <= d
    assert smem == 4 * MAX_COEFFS + warps * per_warp
    assert smem <= 48 * 1024
    assert warps == 8 or 4 * MAX_COEFFS + (warps + 1) * per_warp > 48 * 1024
    if d_chunk < d:
        assert d_chunk % 32 == 0 and 4 * MAX_COEFFS + _bwd_per_warp(heads, b, d) > 48 * 1024


def test_backward_launch_config_rejects_oversized_rows():
    with pytest.raises(ValueError, match="shared memory"):
        backward_launch_config(64, 1024, 16)


def test_backward_launch_config_of_the_training_shape():
    """sbm_1m layer 1 (H8 B16 D16): the whole tile in one chunk at a row
    stride of 20 floats, 8 warps of 4.9 KB slices; the grid is one wave of
    the blocks that fit."""
    assert [_bwd_ld(c) for c in (16, 48, 96, 12, 7, 1)] == [20, 52, 100, 20, 7, 1]
    warps, d_chunk, smem = backward_launch_config(8, 16, 16)
    assert (warps, d_chunk) == (8, 16)
    floats = 5 * 128 + 16 + 16 * 20 + 8 * 20 + 2 * 8
    assert smem == 4 * MAX_COEFFS + 8 * 4 * (floats + MAX_COEFFS)
    assert wave_grid(10**6, warps, 4, sm_count=132) == 132 * 4


def test_backward_launch_config_opts_in_past_the_default_block():
    """A node whose scores alone outgrow 48 KB opts in to more shared
    memory, below the 227 KB a block can have, with the whole tile."""
    warps, d_chunk, smem = backward_launch_config(64, 96, 16)
    assert (warps, d_chunk) == (1, 16) and 48 * 1024 < smem <= 227 * 1024


@pytest.mark.parametrize("nodes,warps,per_sm,want", [
    (10, 8, 4, 2), (4099, 8, 4, 513), (10**6, 1, 1, 132), (10**6, 6, 3, 396), (10**6, 8, 0, 132),
    (62_500, 1, 3, 396), (10, 1, 3, 10),          # the forward: node tiles, one per block
])
def test_backward_grid_is_at_most_one_wave(nodes, warps, per_sm, want):
    """One wave of the blocks the occupancy query says fit (at least one
    per SM), fewer when there are fewer nodes than warps; the forward's
    tiles go one per block at a time."""
    assert wave_grid(nodes, warps, per_sm, sm_count=132) == want


def test_backward_raises_when_the_library_cannot_load(monkeypatch):
    def no_library(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cheb_mod, "_lib", None)
    monkeypatch.setattr(_build, "load_library", no_library)
    x, h, m, dout = _grad_inputs("3d", "negative")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cheb_attn_backward(*_meta(x, h, m, ATT16, dout))


def test_non_cuda_device_is_refused_by_the_backward_wrapper(monkeypatch):
    monkeypatch.setattr(cheb_mod, "_lib", object())
    before = cheb_attn_backward.launches
    x, h, m, dout = _grad_inputs("3d", "negative")
    with pytest.raises(ValueError, match="one CUDA device"):
        cheb_attn_backward(*_meta(x, h, m, ATT16, dout))
    assert cheb_attn_backward.launches == before


def test_cpu_gradients_launch_no_kernel():
    before = (cheb_attn.launches, cheb_attn_backward.launches)
    _port_grads(*_grad_inputs("2d", "negative"))
    assert (cheb_attn.launches, cheb_attn_backward.launches) == before


# ---- nbr_gather: plain indexing on the CPU; the backward's plan and its
# plain version, which repeats the CUDA kernel's order of additions ----

CHUNK = gather_mod.CHUNK


def _padded_lists(n, b, nodes=None, seed=0, hub_share=0.5):
    """A padded neighbour list as csr_to_padded makes it: a row's slots past
    its degree point at node 0."""
    rng = np.random.default_rng(seed)
    nodes = nodes or n
    idx = rng.integers(0, nodes, (n, b))
    deg = rng.integers(0, b + 1, n)
    deg[rng.random(n) >= hub_share] = b
    idx[np.arange(b)[None, :] >= deg[:, None]] = 0
    return torch.from_numpy(idx)


GATHER_SHAPES = {            # (rows, B, nodes, H, F)
    "scores-8-heads": (700, 32, 700, 8, 1),
    "scores-1-head": (700, 32, 700, 1, 1),
    "rows-40": (700, 32, 700, 1, 40),
    "rows-odd-width": (300, 7, 300, 2, 5),
    "B-1": (3 * CHUNK + 1, 1, 500, 2, 4),
    "empty-segments": (50, 3, 5000, 1, 8),
    "one-chunk": (CHUNK, 1, 40, 1, 1),
    "chunk-plus-one": (CHUNK + 1, 1, 40, 3, 1),
    "chunk-less-one": (CHUNK - 1, 1, 40, 1, 4),
}


@pytest.mark.parametrize("shape", list(GATHER_SHAPES))
def test_gather_plan_is_a_stable_order_whose_runs_cover_every_slot(shape):
    rows, b, nodes, _, _ = GATHER_SHAPES[shape]
    idx = _padded_lists(rows, b, nodes)
    perm, keys = gather_mod.gather_plan(idx, nodes)
    assert perm.dtype == keys.dtype == torch.int32
    flat = idx.reshape(-1)
    assert torch.equal(torch.sort(perm.long()).values, torch.arange(flat.numel()))
    assert torch.equal(flat[perm.long()], keys.long())
    assert (keys[1:] >= keys[:-1]).all()
    same = keys[1:] == keys[:-1]
    assert (perm[1:][same] > perm[:-1][same]).all()          # stable: slot order in a run
    runs = torch.bincount(keys.long(), minlength=nodes)
    assert runs.sum() == rows * b and torch.equal(runs, torch.bincount(flat, minlength=nodes))


def test_gather_plan_counts_a_negative_index_from_the_end():
    idx = torch.tensor([[0, -1], [2, -3]])
    perm, keys = gather_mod.gather_plan(idx, 5)
    assert keys.tolist() == [0, 2, 2, 4] and perm.tolist() == [0, 2, 3, 1]


def _index_backward(x, idx, grad):
    x = x.detach().requires_grad_(True)
    return torch.autograd.grad(x[:, idx, :], x, grad)[0]


@pytest.mark.parametrize("shape", list(GATHER_SHAPES))
def test_plain_segment_sum_matches_autograd_through_indexing(shape):
    rows, b, nodes, heads, f = GATHER_SHAPES[shape]
    idx = _padded_lists(rows, b, nodes, seed=1)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((heads, nodes, f)))
    grad = torch.from_numpy(rng.standard_normal((heads, rows, b, f)))
    want = _index_backward(x, idx, grad)
    # float64: only the order of the additions differs
    torch.testing.assert_close(gather_mod.nbr_gather_backward_plain(grad, idx, nodes), want,
                               rtol=1e-12, atol=1e-12)
    # float32, the kernels' type: the chunked order against the index backward's
    got32 = gather_mod.nbr_gather_backward_plain(grad.float(), idx, nodes)
    torch.testing.assert_close(got32, want.float(), rtol=1e-5, atol=1e-5)


def test_plain_segment_sum_folds_a_hub_over_many_chunks_in_levels():
    """A node with 10**5 slots spans ~1,600 chunks, so its partials fold in
    three levels; every other run is short."""
    rng = np.random.default_rng(3)
    idx = _padded_lists(4000, 32, 4000, seed=4, hub_share=0.0)
    flat = idx.view(-1)
    flat[torch.from_numpy(rng.choice(flat.numel(), 10 ** 5, replace=False))] = 7
    grad = torch.from_numpy(rng.standard_normal((2, 4000, 32, 3)))
    x = torch.zeros(2, 4000, 3, dtype=torch.float64)
    want = _index_backward(x, idx, grad)
    levels, n = 0, idx.numel()
    while True:
        levels += 1
        if n <= CHUNK:
            break
        n = 2 * -(-n // CHUNK)
    assert levels >= 3
    torch.testing.assert_close(gather_mod.nbr_gather_backward_plain(grad, idx, 4000), want,
                               rtol=1e-12, atol=1e-12)


def test_plain_levels_keep_each_crossing_run_contiguous():
    """What lets a next level fold the partials: each key's entries form
    one run, and a key written at one level never reaches the next."""
    rng = np.random.default_rng(5)
    keys = torch.from_numpy(np.sort(rng.integers(0, 40, 5000)).astype(np.int32))
    keys[keys == 3] = 2                        # one long run, others short
    vals = torch.ones(1, keys.numel(), 1, dtype=torch.float64)
    dx = torch.zeros(1, 40, 1, dtype=torch.float64)
    written = set()
    level = (vals, keys)
    while level is not None:
        before = dx.clone()
        level = gather_mod._level_plain(*level, dx)
        now = set(torch.nonzero((dx != before).view(-1)).view(-1).tolist())
        assert not now & written
        written |= now
        if level is not None:
            k = level[1][level[1] >= 0]
            starts = torch.cat([torch.tensor([True]), k[1:] != k[:-1]])
            assert len(set(k.tolist())) == int(starts.sum())
            assert not set(k.tolist()) & written
    assert torch.equal(dx.view(-1), torch.bincount(keys.long(), minlength=40).double())


def test_nbr_gather_on_cpu_is_plain_indexing_bit_for_bit():
    idx = _padded_lists(300, 16, 300, seed=6)
    rng = np.random.default_rng(7)
    for heads, f in ((8, 1), (1, 40)):
        x = torch.from_numpy(rng.standard_normal((heads, 300, f)).astype(np.float32))
        grad = torch.from_numpy(rng.standard_normal((heads, 300, 16, f)).astype(np.float32))
        before = gather_mod.nbr_gather_backward.launches
        xa, xb = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
        ya, yb = gather_mod.nbr_gather(xa, idx), xb[:, idx, :]
        assert torch.equal(ya, yb)
        ga, = torch.autograd.grad(ya, xa, grad)
        gb, = torch.autograd.grad(yb, xb, grad)
        assert torch.equal(ga, gb)
        assert gather_mod.nbr_gather_backward.launches == before


def test_nbr_gather_without_a_gradient_is_plain_indexing_on_any_device(monkeypatch):
    """Serving and evaluate run the gathers forward only: no node, no kernel."""
    monkeypatch.setattr(gather_mod, "_lib", None)
    monkeypatch.setattr(_build, "load_library", lambda name: pytest.fail("no kernel"))
    x = torch.empty((2, 10, 3), device="meta")
    idx = torch.zeros((10, 4), dtype=torch.int64, device="meta")
    assert gather_mod.nbr_gather(x, idx).shape == (2, 10, 4, 3)
    with torch.no_grad():
        assert gather_mod.nbr_gather(x.requires_grad_(True), idx).grad_fn is None
    with torch.inference_mode():
        y = torch.randn(2, 10, 3, requires_grad=True)
        assert gather_mod.nbr_gather(y, torch.zeros((10, 4), dtype=torch.int64)).grad_fn is None


def test_nbr_gather_refuses_a_tensor_off_the_cpu_it_cannot_take():
    x = torch.empty((2, 10, 3), device="meta", requires_grad=True)
    idx = torch.zeros((10, 4), dtype=torch.int64, device="meta")
    with pytest.raises(TypeError, match="CUDA device"):
        gather_mod.nbr_gather(x, idx)


def test_nbr_gather_backward_raises_when_the_library_cannot_load(monkeypatch):
    def no_library(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(gather_mod, "_lib", None)
    monkeypatch.setattr(_build, "load_library", no_library)
    grad = torch.empty((2, 10, 4, 3), device="meta")
    idx = torch.zeros((10, 4), dtype=torch.int64, device="meta")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        gather_mod.nbr_gather_backward(grad, idx, 10)


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_non_cuda_device_is_refused_by_the_gather_backward_wrapper(monkeypatch, device):
    """The CPU's backward is nbr_gather_backward_plain, which nbr_gather's
    plain indexing never needs; the kernel's wrapper refuses a CPU tensor."""
    monkeypatch.setattr(gather_mod, "_lib", object())
    before = gather_mod.nbr_gather_backward.launches
    grad = torch.empty((2, 10, 4, 3), device=device)
    idx = torch.zeros((10, 4), dtype=torch.int64, device=device)
    with pytest.raises(ValueError, match="one CUDA device"):
        gather_mod.nbr_gather_backward(grad, idx, 10)
    assert gather_mod.nbr_gather_backward.launches == before
