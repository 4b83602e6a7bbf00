"""repro_torch's cheb_attn against the JAX package.

On the CPU the wrapper runs its plain version; the JAX side runs its Pallas
kernel in interpret mode and its jnp oracle. The CUDA kernel itself is held
against the plain version by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``, which skips without a card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.chebyshev import attention_series
from repro.kernels import ref as jref
from repro.kernels.cheb_attn import cheb_attn as jax_cheb_attn
from repro_torch.kernels import _build
from repro_torch.kernels import cheb_attn as cheb_mod
from repro_torch.kernels.cheb_attn import MAX_COEFFS, cheb_attn, launch_config

torch.set_num_threads(1)

ATT16 = attention_series(16, (-4.0, 4.0)).astype(np.float32)
RTOL, ATOL = 1e-4, 5e-5          # tests/test_kernel_engine.py:149


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


@pytest.mark.parametrize("heads,b,d", [(8, 16, 16), (8, 24, 48), (1, 8, 1), (3, 5, 300), (16, 64, 128)])
def test_launch_config_fits_the_block(heads, b, d):
    node_tile, d_tile, smem = launch_config(heads, b, d)
    assert node_tile * d_tile <= 256 and node_tile >= 1
    assert d_tile >= min(d, 256) and d_tile & (d_tile - 1) == 0
    assert smem == 4 * MAX_COEFFS + node_tile * 4 * heads * ((b | 1) + 1)
    assert smem <= 48 * 1024 or node_tile == 1


def test_launch_config_rejects_oversized_rows():
    with pytest.raises(ValueError, match="shared memory"):
        launch_config(64, 1024, 16)


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
    assert _build.kernel_names() == ["cheb_attn"]
