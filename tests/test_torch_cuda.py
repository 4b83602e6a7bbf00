"""The CUDA kernel against its plain version, on the card.

Imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every test skips.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.chebyshev import attention_series
from repro_torch.kernels.cheb_attn import cheb_attn
from repro_torch.kernels.ref import cheb_attn_ref

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
