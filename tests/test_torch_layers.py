"""repro_torch layers and the layered forward against the JAX package, on
the same numpy-seeded inputs and the same JAX-made parameters."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import FedGATConfig as JFedGATConfig
from repro.core import get_engine as j_get_engine
from repro.core.fedgat_model import init_params as j_init_params
from repro.core.fedgat_model import layered_forward as j_layered_forward
from repro.core.gat import gat_layer_nbr as j_gat_layer_nbr
from repro.core.gat import masked_accuracy as j_masked_accuracy
from repro.core.poly_attention import poly_gat_layer as j_poly_gat_layer
from repro.graphs import make_cora_like as j_make_cora_like
from repro.kernels.ops import cheb_attn_layer as j_cheb_attn_layer
from repro_torch.core import FedGAT, FedGATConfig, get_engine, init_params, layered_forward
from repro_torch.core import params_from_numpy
from repro_torch.core.fedgat_model import graph_tensors, layer_shapes
from repro_torch.core.gat import gat_layer_nbr, masked_accuracy
from repro_torch.core.poly_attention import poly_gat_layer
from repro_torch.graphs import make_cora_like
from repro_torch.kernels.ops import cheb_attn_layer

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5          # tests/test_kernel_engine.py:184
ATT16 = JFedGATConfig().coeffs().astype(np.float32)


def _layer_inputs(n, d, B=8, H=4, o=6, seed=0):
    """Unit-norm feature rows, as the repo's graphs have them (paper
    Assumption 3), keep the edge scores inside the series' fitted domain
    [-4, 4]; outside it the degree-16 monomial sum cancels so badly that
    two summation orders disagree well above float32 rounding."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d))
    h = (h / np.linalg.norm(h, axis=1, keepdims=True)).astype(np.float32)
    nbr_idx = rng.integers(0, n, size=(n, B)).astype(np.int32)
    nbr_mask = rng.random((n, B)) < 0.6
    nbr_mask[:, 0] = True
    nbr_mask[n // 2] = False                     # an isolated node
    params = {
        "W": (0.1 * np.sqrt(d) * rng.standard_normal((H, d, o))).astype(np.float32),
        "a1": (0.2 * rng.standard_normal((H, o))).astype(np.float32),
        "a2": (0.2 * rng.standard_normal((H, o))).astype(np.float32),
    }
    return h, nbr_idx, nbr_mask, params


def _torch(h, nbr_idx, nbr_mask, params):
    return (
        torch.from_numpy(h), torch.from_numpy(nbr_idx).long(),
        torch.from_numpy(nbr_mask), params_from_numpy([params], device=CPU)[0],
    )


def _jax(h, nbr_idx, nbr_mask, params):
    return (
        jnp.asarray(h), jnp.asarray(nbr_idx), jnp.asarray(nbr_mask),
        {k: jnp.asarray(v) for k, v in params.items()},
    )


@pytest.mark.parametrize("concat", [True, False])
@pytest.mark.parametrize("n,d", [(13, 10), (50, 22), (127, 129)])
def test_cheb_attn_layer_matches_jax(n, d, concat):
    inp = _layer_inputs(n, d, seed=n)
    th, ti, tm, tp = _torch(*inp)
    jh, ji, jm, jp = _jax(*inp)
    with torch.no_grad():
        got = cheb_attn_layer(tp, torch.from_numpy(ATT16), th, ti, tm, concat=concat).numpy()
    want = np.asarray(j_cheb_attn_layer(jp, jnp.asarray(ATT16), jh, ji, jm, concat=concat))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("basis", ["power", "chebyshev"])
@pytest.mark.parametrize("n,d", [(13, 10), (127, 129)])
def test_poly_gat_layer_matches_jax(n, d, basis):
    inp = _layer_inputs(n, d, seed=d)
    th, ti, tm, tp = _torch(*inp)
    jh, ji, jm, jp = _jax(*inp)
    coeffs = JFedGATConfig(basis=basis).coeffs().astype(np.float32)
    with torch.no_grad():
        got = poly_gat_layer(tp, torch.from_numpy(coeffs), th, ti, tm, basis=basis).numpy()
    want = np.asarray(j_poly_gat_layer(jp, jnp.asarray(coeffs), jh, ji, jm, basis=basis))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("concat", [True, False])
def test_gat_layer_nbr_matches_jax(concat):
    inp = _layer_inputs(50, 22, seed=7)
    th, ti, tm, tp = _torch(*inp)
    jh, ji, jm, jp = _jax(*inp)
    with torch.no_grad():
        got = gat_layer_nbr(tp, th, ti, tm, concat=concat).numpy()
    want = np.asarray(j_gat_layer_nbr(jp, jh, ji, jm, concat=concat))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def cora():
    return make_cora_like("cora_like", seed=0), j_make_cora_like("cora_like", seed=0)


@pytest.mark.parametrize("num_layers", [2, 3])
@pytest.mark.parametrize("engine", ["direct", "kernel", "exact"])
def test_layered_forward_matches_jax(cora, engine, num_layers):
    g, jg = cora
    jcfg = JFedGATConfig(engine=engine, num_layers=num_layers)
    jparams = j_init_params(jax.random.PRNGKey(num_layers), jg.feature_dim, jg.num_classes, jcfg)
    je = j_get_engine(engine)(jcfg)
    jco = jnp.asarray(jcfg.coeffs(), jnp.float32) if je.needs_coeffs else None
    want = np.asarray(j_layered_forward(
        je, jparams, jco, None,
        jnp.asarray(jg.features), jnp.asarray(jg.nbr_idx), jnp.asarray(jg.nbr_mask),
    ))

    cfg = FedGATConfig(**dataclasses.asdict(jcfg))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    e = get_engine(engine)(cfg)
    co = torch.as_tensor(cfg.coeffs(), dtype=torch.float32) if e.needs_coeffs else None
    with torch.no_grad():
        got = layered_forward(e, params, co, None, *graph_tensors(g, CPU)).numpy()
        facade = FedGAT(cfg, device="cpu").apply(params, g).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(facade, got)
    labels = torch.from_numpy(g.labels).long()
    acc = float(masked_accuracy(torch.from_numpy(got), labels, torch.from_numpy(g.test_mask)))
    jacc = float(j_masked_accuracy(jnp.asarray(want), jnp.asarray(jg.labels), jnp.asarray(jg.test_mask)))
    assert acc == pytest.approx(jacc, abs=1.0 / g.test_mask.sum())


@pytest.mark.parametrize("num_layers", [2, 4])
def test_init_params_shapes_and_range(num_layers):
    cfg = FedGATConfig(num_layers=num_layers)
    params = init_params(torch.Generator().manual_seed(0), 48, 7, cfg, device="cpu")
    again = init_params(torch.Generator().manual_seed(0), 48, 7, cfg, device="cpu")
    jparams = j_init_params(jax.random.PRNGKey(0), 48, 7, JFedGATConfig(num_layers=num_layers))
    assert len(params) == len(jparams) == len(layer_shapes(48, 7, cfg))
    for p, q, jp, (heads, d_in, d_out) in zip(params, again, jparams, layer_shapes(48, 7, cfg)):
        lim = 0.5 * np.sqrt(6.0 / (d_in + d_out))
        for k in ("W", "a1", "a2"):
            assert tuple(p[k].shape) == jp[k].shape
            assert float(p[k].detach().abs().max()) <= lim
            torch.testing.assert_close(p[k], q[k], rtol=0, atol=0)
        assert tuple(p["W"].shape) == (heads, d_in, d_out)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedGAT(FedGATConfig(engine="kernel"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(torch.Generator(), 4, 2, FedGATConfig())
