"""The CUDA kernels against their plain versions, and a short federated
training run on the card against the same run on the CPU.

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
from repro_torch.kernels.cheb_attn import cheb_attn, cheb_attn_backward
from repro_torch.kernels.ref import cheb_attn_bwd_ref, cheb_attn_ref

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
