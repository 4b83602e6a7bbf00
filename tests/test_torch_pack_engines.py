"""The port's pack engines (Matrix FedGAT, Vector FedGAT) against the JAX
package: the packs, the projector algebra, both layers in both bases, the
facade's pack lifecycle, gradients, the Trainer end to end and the error
bounds, on numpy-seeded inputs at the reference tests' tolerances
(``tests/test_fedgat_engines.py``).

Torch cannot reproduce ``jax.random`` bits. Where a test holds a pack
itself against the reference's, it injects the reference's draws: the
orthogonal matrices ``q = qr(normal(key, (N, g, g)))[0]`` of
``make_projectors`` and the four raw mask normals of
``precompute_vector_pack``. The layers' outputs do not depend on the draws
(the vector masks sit on slots the layer zeroes exactly; the matrix
projectors cancel up to rounding), so the layers are also held against the
reference with the port's own draws.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.analysis import error_bounds as jeb
from repro.core import FedGATConfig as JFedGATConfig
from repro.core import fedgat_matrix as jm
from repro.core import fedgat_vector as jv
from repro.core.fedgat_model import FedGAT as JFedGAT
from repro.core.fedgat_model import fedgat_forward as j_fedgat_forward
from repro.core.fedgat_model import init_params as j_init_params
from repro.core.poly_attention import edge_scores as j_edge_scores
from repro.core.poly_attention import head_projections as j_head_projections
from repro.core.poly_attention import moments_direct as j_moments_direct
from repro.federated import trainer as jtrainer
from repro.graphs import make_cora_like as j_make_cora_like
from repro.graphs import make_sbm as j_make_sbm
from repro_torch.analysis import error_bounds as eb
from repro_torch.core import (
    FedGAT,
    FedGATConfig,
    FedGATPack,
    VectorPack,
    fedgat_forward,
    get_engine,
    make_pack,
    pack_from_numpy,
    params_from_numpy,
    registered_engines,
)
from repro_torch.core import fedgat_matrix as tm
from repro_torch.core import fedgat_vector as tv
from repro_torch.core.fedgat_model import graph_tensors
from repro_torch.core.poly_attention import poly_gat_layer
from repro_torch.federated import trainer
from repro_torch.federated.trainer import FederatedConfig, run_federated, train_centralized
from repro_torch.graphs import make_cora_like, make_sbm

torch.set_num_threads(1)

CPU = torch.device("cpu")
PACK_TOL = (1e-5, 1e-6)          # a pack against the reference's, same draws
MATRIX_TOL = (1e-3, 1e-4)        # tests/test_fedgat_engines.py:110
VECTOR_TOL = (1e-4, 1e-5)        # :121
MOMENT_TOL = (2e-3, 2e-4)        # :70-71
GRAD_TOL = (5e-3, 5e-4)          # :173
PROJ_ATOL = 1e-5                 # :50-53
CURVE_ATOL = 1e-6
RTOL, ATOL = 1e-3, 1e-4          # final params, as tests/test_torch_federated.py
NOISE_ONLY = {(1, "a1")}         # see tests/test_torch_federated.py
LAYER_TOL = {"matrix": MATRIX_TOL, "vector": VECTOR_TOL}


@pytest.fixture(scope="module")
def graphs():
    return {
        "tiny": (make_cora_like("tiny", seed=0), j_make_cora_like("tiny", seed=0)),
        "sbm1k": (make_sbm("sbm_1k", seed=0), j_make_sbm("sbm_1k", seed=0)),
    }


def _case(graphs, name, degree=12, basis="power"):
    """(port graph, jax graph, port arrays, jax arrays, jax params, port params, cfgs)."""
    g, jg = graphs[name]
    jcfg = JFedGATConfig(degree=degree, basis=basis)
    jparams = j_init_params(jax.random.PRNGKey(1), jg.feature_dim, jg.num_classes, jcfg)
    params = params_from_numpy(_numpy_tree(jparams), device=CPU)
    jarr = (jnp.asarray(jg.features), jnp.asarray(jg.nbr_idx), jnp.asarray(jg.nbr_mask))
    return g, jg, graph_tensors(g, CPU), jarr, jparams, params, (
        FedGATConfig(degree=degree, basis=basis), jcfg)


def _numpy_tree(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _ref_q(key, n, b):
    """The orthogonal matrices the reference's make_projectors draws under ``key``."""
    g = 2 * b
    return torch.from_numpy(np.array(jnp.linalg.qr(jax.random.normal(key, (n, g, g)))[0]))


def _ref_masks(key, n, d, b):
    """The four raw normals the reference's precompute_vector_pack draws under ``key``."""
    g = 2 * b
    ks = jax.random.split(key, 4)
    shapes = ((n, d, g), (n, d, g), (n, g, d), (n, g))
    return [torch.from_numpy(np.array(jax.random.normal(k, s, jnp.float32)))
            for k, s in zip(ks, shapes)]


def _ref_pack(engine, key, jarr, tarr):
    """(the reference's pack, the port's pack built from the same draws)."""
    h, idx, mask = tarr
    n, b = mask.shape
    if engine == "matrix":
        return (jm.precompute_pack(key, *jarr),
                tm.precompute_pack(None, h, idx, mask, q=_ref_q(key, n, b)))
    return (jv.precompute_vector_pack(key, *jarr),
            tv.precompute_vector_pack(None, h, idx, mask,
                                      masks=_ref_masks(key, n, h.shape[1], b)))


def _close(got, want, tol, msg=""):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
                 for a in (got, want))
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1], err_msg=msg)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def test_both_pack_engines_are_registered_as_in_the_reference():
    from repro.core.engine import get_engine as j_get_engine

    assert registered_engines() == ["direct", "exact", "kernel", "matrix", "vector"]
    for name in registered_engines():
        cls, jcls = get_engine(name), j_get_engine(name)
        assert (cls.needs_pack, cls.needs_coeffs, cls.comm_cost_model) == (
            jcls.needs_pack, jcls.needs_coeffs, jcls.comm_cost_model), name
        if not cls.needs_pack:
            assert cls(FedGATConfig()).precompute(None, None, None, None) is None


# ---------------------------------------------------------------------------
# The packs against the reference's, same draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["tiny", "sbm1k"])
@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_pack_matches_the_reference_with_its_draws(graphs, graph, engine):
    _, _, tarr, jarr, *_ = _case(graphs, graph)
    jpack, pack = _ref_pack(engine, jax.random.PRNGKey(5), jarr, tarr)
    assert type(pack).__name__ == type(jpack).__name__
    assert pack._fields == jpack._fields
    for name in pack._fields:
        a, b = getattr(pack, name), getattr(jpack, name)
        if name == "r":
            assert a == b == 1.7
            continue
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32, name
        _close(a, b, PACK_TOL, name)


@pytest.mark.parametrize("seed,r", [(0, 1.7), (1, 0.5), (2, 2.5), (3, 5.0), (4, 1.0)])
def test_projector_properties(seed, r):
    """Paper Eq. 9: U_j idempotent, U_j U_k = 0, invalid slots empty
    (tests/test_fedgat_engines.py:45-55), with the port's own draws."""
    mask = torch.tensor([[True] * 5 + [False] * 3])
    U, u1, u2 = tm.make_projectors(torch.Generator().manual_seed(seed), mask, r)
    Un = U[0].numpy()
    for j in range(5):
        np.testing.assert_allclose(Un[j] @ Un[j], Un[j], atol=PROJ_ATOL)
        for k in range(8):
            if k != j:
                np.testing.assert_allclose(Un[j] @ Un[k], 0.0, atol=PROJ_ATOL)
    np.testing.assert_allclose(Un[6], 0.0, atol=1e-7)
    # And the reference's projectors from its own q, through the port.
    jU, ju1, ju2 = jm.make_projectors(jax.random.PRNGKey(seed), jnp.asarray(mask.numpy()), r)
    tU, tu1, tu2 = tm.make_projectors(None, mask, r, q=_ref_q(jax.random.PRNGKey(seed), 1, 8))
    for a, b in ((tU, jU), (tu1, ju1), (tu2, ju2)):
        _close(a, b, PACK_TOL)


@pytest.mark.parametrize("n", range(6))
def test_projector_moment_identity(graphs, n):
    """D^n = sum_j x^n U_j, so one-hot coefficients pick out E^(n), F^(n)
    (Eq. 12), with the port's own draws, against the reference's oracle."""
    _, _, (h, idx, mask), jarr, jparams, params, _ = _case(graphs, "tiny")
    pack = tm.precompute_pack(torch.Generator().manual_seed(3), h, idx, mask)
    b1, b2 = tm.head_projections(params[0])
    D = tm.build_D(pack, h, b1, b2)
    assert D.shape == (8, h.shape[0], 2 * mask.shape[1], 2 * mask.shape[1])
    jb1, jb2 = j_head_projections(jparams[0])
    jh, jidx, jmask = jarr
    E, F = j_moments_direct(j_edge_scores(jb1, jb2, jh, jidx), jh[jidx], jmask, max_n=5)
    c = torch.zeros(6)
    c[n] = 1.0
    SE, SF = tm.series_moments(pack, D, c)
    _close(SE, E[n], MOMENT_TOL)
    _close(SF, F[n], MOMENT_TOL)


def test_series_moments_refuses_what_the_reference_refuses(graphs):
    _, _, (h, idx, mask), _, _, params, _ = _case(graphs, "tiny")
    pack = tm.precompute_pack(torch.Generator().manual_seed(0), h, idx, mask)
    D = tm.build_D(pack, h, *tm.head_projections(params[0]))
    with pytest.raises(ValueError, match="symmetric"):
        tm.series_moments(pack, D, torch.ones(3), basis="chebyshev", domain=(-2.0, 4.0))
    with pytest.raises(ValueError, match="unknown basis"):
        tm.series_moments(pack, D, torch.ones(3), basis="legendre")
    vp = tv.precompute_vector_pack(torch.Generator().manual_seed(0), h, idx, mask)
    with pytest.raises(ValueError, match="unknown basis"):
        tv.fedgat_layer_vector(params[0], vp, h, torch.ones(3), basis="legendre")


# ---------------------------------------------------------------------------
# The layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draws", ["reference", "own"])
@pytest.mark.parametrize("basis", ["power", "chebyshev"])
@pytest.mark.parametrize("graph", ["tiny", "sbm1k"])
@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_layer_matches_the_reference_layer_and_direct(graphs, engine, graph, basis, draws):
    _, _, tarr, jarr, jparams, params, (cfg, jcfg) = _case(graphs, graph, basis=basis)
    h, idx, mask = tarr
    key = jax.random.PRNGKey(6)
    jpack, pack = _ref_pack(engine, key, jarr, tarr)
    if draws == "own":
        pack = get_engine(engine)(cfg).precompute(torch.Generator().manual_seed(6), h, idx, mask)
    coeffs = torch.as_tensor(cfg.coeffs(), dtype=torch.float32)
    jcoeffs = jnp.asarray(jcfg.coeffs(), jnp.float32)
    layer, jlayer = {"matrix": (tm.fedgat_layer_matrix, jm.fedgat_layer_matrix),
                     "vector": (tv.fedgat_layer_vector, jv.fedgat_layer_vector)}[engine]
    tol = LAYER_TOL[engine]
    for concat in (True, False):
        out = layer(params[0], pack, h, coeffs, basis=basis, domain=cfg.domain, concat=concat)
        want = jlayer(jparams[0], jpack, jarr[0], jcoeffs, basis=basis, domain=jcfg.domain,
                      concat=concat)
        direct = poly_gat_layer(params[0], coeffs, h, idx, mask, basis=basis,
                                domain=cfg.domain, concat=concat)
        assert out.shape == want.shape
        _close(out, want, tol, "against the reference layer")
        _close(out, direct, tol, "against the direct engine")


@pytest.mark.parametrize("graph", ["tiny", "sbm1k"])
def test_full_model_engines_agree_with_the_reference(graphs, graph):
    g, jg, (h, idx, mask), jarr, jparams, params, (cfg, jcfg) = _case(graphs, graph)
    coeffs = torch.as_tensor(cfg.coeffs(), dtype=torch.float32)
    jcoeffs = jnp.asarray(jcfg.coeffs(), jnp.float32)
    outs = {}
    for engine in ("matrix", "vector", "direct"):
        ecfg = FedGATConfig(degree=12, engine=engine)
        jecfg = JFedGATConfig(degree=12, engine=engine)
        pack = make_pack(torch.Generator().manual_seed(7), ecfg, h, idx, mask)
        jpack = (None if engine == "direct"
                 else _ref_pack(engine, jax.random.PRNGKey(7), jarr, (h, idx, mask))[0])
        outs[engine] = fedgat_forward(params, ecfg, coeffs, pack, h, idx, mask)
        want = j_fedgat_forward(jparams, jecfg, jcoeffs, jpack, *jarr)
        _close(outs[engine], want, LAYER_TOL.get(engine, VECTOR_TOL), engine)
    _close(outs["matrix"], outs["direct"], MATRIX_TOL)
    _close(outs["vector"], outs["direct"], VECTOR_TOL)


@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_isolated_nodes_aggregate_to_zeros_not_nan(graphs, engine):
    _, _, (h, idx, mask), _, _, params, (cfg, _) = _case(graphs, "tiny")
    mask = mask.clone()
    iso = [0, 5, 17]
    mask[iso] = False
    pack = get_engine(engine)(cfg).precompute(torch.Generator().manual_seed(2), h, idx, mask)
    out = get_engine(engine)(cfg).apply(
        params[0], pack, torch.as_tensor(cfg.coeffs(), dtype=torch.float32), h, idx, mask)
    assert torch.isfinite(out).all()
    assert bool((out[iso] == 0).all())
    assert bool((out.abs().sum(-1) > 0).sum() >= h.shape[0] - len(iso))


@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_gradients_flow_through_pack_engines(graphs, engine):
    """FedGAT trains THROUGH the approximation: the port's gradients match
    the reference's through the same pack, and the direct engine's."""
    _, _, (h, idx, mask), jarr, jparams, params, _ = _case(graphs, "tiny")
    ecfg, jecfg = FedGATConfig(degree=10, engine=engine), JFedGATConfig(degree=10, engine=engine)
    coeffs = torch.as_tensor(ecfg.coeffs(), dtype=torch.float32)
    jcoeffs = jnp.asarray(jecfg.coeffs(), jnp.float32)
    jpack, pack = _ref_pack(engine, jax.random.PRNGKey(8), jarr, (h, idx, mask))

    def grads(cfg, pk):
        tree = trainer.param_tree(params)
        return trainer.grad_of(
            lambda p: (fedgat_forward(p, cfg, coeffs, pk, h, idx, mask) ** 2).sum(), tree)

    jgrads = jax.grad(lambda p: jnp.sum(j_fedgat_forward(p, jecfg, jcoeffs, jpack, *jarr) ** 2))(
        jparams)
    got = grads(ecfg, pack)
    direct = grads(FedGATConfig(degree=10, engine="direct"), None)
    for layer, jlayer, dlayer in zip(got, jgrads, direct):
        for k in jlayer:
            _close(layer[k], jlayer[k], GRAD_TOL, f"{k} against the reference")
            _close(layer[k], dlayer[k], GRAD_TOL, f"{k} against direct")


# ---------------------------------------------------------------------------
# The facade, the free functions, packs carried across
# ---------------------------------------------------------------------------

def test_facade_pack_lifecycle(graphs):
    g, jg, *_ = _case(graphs, "tiny")
    model = FedGAT(FedGATConfig(engine="matrix", degree=12), device=CPU)
    params = model.init(torch.Generator().manual_seed(0), g)
    with pytest.raises(RuntimeError, match="needs a pack"):
        model.apply(params, g)
    pack = model.precommunicate(torch.Generator().manual_seed(4), g)
    assert isinstance(pack, FedGATPack) and model.pack is pack
    other = make_cora_like("tiny", seed=0)           # equal arrays, another object
    with pytest.raises(RuntimeError, match="different graph"):
        model.apply(params, other)
    out = model.apply(params, g)
    again = model.refresh_pack(torch.Generator().manual_seed(4), g)
    for a, b in zip(pack[:4], again[:4]):
        assert torch.equal(a, b)                     # same generator state, same pack
    model.install_pack(pack, other)
    assert torch.equal(model.apply(params, other), out)
    direct = FedGAT(FedGATConfig(engine="direct", degree=12), device=CPU)
    assert direct.precommunicate(torch.Generator(), g) is None
    with pytest.raises(ValueError, match="takes no pack"):
        direct.install_pack(pack, g)


@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_a_reference_pack_serves_through_the_port_facade(graphs, engine):
    g, jg, _, _, jparams, params, _ = _case(graphs, "tiny")
    jmodel = JFedGAT(JFedGATConfig(engine=engine, degree=12))
    jpack = jmodel.precommunicate(jax.random.PRNGKey(9), jg)
    model = FedGAT(FedGATConfig(engine=engine, degree=12), device=CPU)
    model.install_pack(type(jpack)(*(np.asarray(a) if getattr(a, "ndim", 0) else a
                                     for a in jpack)), g)
    assert type(model.pack).__name__ == type(jpack).__name__
    _close(model.apply(params, g), jmodel.apply(jparams, jg), LAYER_TOL[engine])


def test_pack_from_numpy_converts_both_packages_packs(graphs):
    _, _, tarr, jarr, *_ = _case(graphs, "tiny")
    for engine, cls in (("matrix", FedGATPack), ("vector", VectorPack)):
        jpack, pack = _ref_pack(engine, jax.random.PRNGKey(1), jarr, tarr)
        got = pack_from_numpy(jpack, device=CPU)
        assert type(got) is cls
        for name in cls._fields:
            a = getattr(got, name)
            if name == "r":
                assert isinstance(a, float) and a == 1.7
            else:
                assert a.dtype == torch.float32 and a.device == CPU
                np.testing.assert_array_equal(a.numpy(), np.asarray(getattr(jpack, name)))
        same = pack_from_numpy(pack, device=CPU)
        assert all(x.data_ptr() == y.data_ptr()           # already there: no copy
                   for x, y in zip(same, pack) if isinstance(x, torch.Tensor))
    assert pack_from_numpy(None, device=CPU) is None
    with pytest.raises(TypeError, match="not a FedGAT pack"):
        pack_from_numpy((np.zeros(3),), device=CPU)


def test_pack_from_numpy_defaults_to_cuda_and_raises_without_it(graphs, monkeypatch):
    _, _, tarr, jarr, *_ = _case(graphs, "tiny")
    jpack, _ = _ref_pack("vector", jax.random.PRNGKey(1), jarr, tarr)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pack_from_numpy(jpack)


# ---------------------------------------------------------------------------
# Training through the pack engines
# ---------------------------------------------------------------------------

def _ref_run(jcfg, jg):
    """The reference's initial params and pack for ``jcfg``, as its
    ``_run_vmap`` draws them (``k_pack, k_init = split(PRNGKey(seed))``)."""
    k_pack, k_init = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    model = JFedGAT(jtrainer.method_model_config(jcfg))
    pack = model.precommunicate(k_pack, jg)
    return _numpy_tree(model.init(k_init, jg)), pack


@pytest.mark.parametrize("draws", ["reference", "own"])
@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_run_federated_matches_the_jax_vmap_trainer(graphs, engine, draws):
    g, jg = graphs["tiny"]
    kw = dict(num_clients=4, rounds=3, local_steps=2, aggregator="fedavg")
    cfg = FederatedConfig(model=FedGATConfig(engine=engine), **kw)
    jcfg = jtrainer.FederatedConfig(model=JFedGATConfig(engine=engine), **kw)
    jres = jtrainer.run_federated(jg, jcfg)
    params, jpack = _ref_run(jcfg, jg)
    res = run_federated(g, cfg, device=CPU, params=params,
                        pack=jpack if draws == "reference" else None)
    np.testing.assert_allclose(res["val_curve"], jres["val_curve"], atol=CURVE_ATOL)
    np.testing.assert_allclose(res["test_curve"], jres["test_curve"], atol=CURVE_ATOL)
    for li, (layer, jlayer) in enumerate(zip(res["params"], jres["params"])):
        for k in jlayer:
            if (li, k) not in NOISE_ONLY:
                _close(layer[k], jlayer[k], (RTOL, ATOL), f"layer {li} {k}")
    assert res["comm"].download_scalars == jres["comm"].download_scalars
    np.testing.assert_array_equal(res["comm"].per_client, jres["comm"].per_client)


def test_default_pack_comes_from_its_own_generator_stream(graphs):
    g, _ = graphs["tiny"]
    cfg = FederatedConfig(num_clients=2, rounds=2, local_steps=1)      # FedGATConfig(): matrix
    a, b = (run_federated(g, cfg, device=CPU) for _ in range(2))
    assert a["val_curve"] == b["val_curve"]
    for p, q in zip(a["params"].parameters(), b["params"].parameters()):
        assert torch.equal(p, q)
    _, forward = trainer.build_forward(cfg, g, CPU)
    init = torch.Generator().manual_seed(cfg.seed)
    pack_gen = trainer.pack_generator(cfg.seed, CPU)
    assert not torch.equal(torch.randn(64, generator=init), torch.randn(64, generator=pack_gen))
    pack = FedGAT(cfg.model, device=CPU).precommunicate(trainer.pack_generator(cfg.seed, CPU), g)
    res = run_federated(g, cfg, device=CPU, pack=pack)
    assert res["val_curve"] == a["val_curve"]
    for p, q in zip(a["params"].parameters(), res["params"].parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_train_centralized_through_a_pack_engine_matches_reference(graphs, engine):
    g, jg = graphs["tiny"]
    jmcfg = JFedGATConfig(engine=engine, degree=10)
    jres = jtrainer.train_centralized(jg, "fedgat", steps=4, mcfg=jmcfg)
    k_pack, k_init = jax.random.split(jax.random.PRNGKey(0))
    jmodel = JFedGAT(jmcfg)
    jpack = jmodel.precommunicate(k_pack, jg)
    res = train_centralized(g, "fedgat", steps=4, mcfg=FedGATConfig(engine=engine, degree=10),
                            device=CPU, params=_numpy_tree(jmodel.init(k_init, jg)), pack=jpack)
    np.testing.assert_allclose(res["val_curve"], jres["val_curve"], atol=CURVE_ATOL)
    np.testing.assert_allclose(res["test_curve"], jres["test_curve"], atol=CURVE_ATOL)
    for li, (layer, jlayer) in enumerate(zip(res["params"], jres["params"])):
        for k in jlayer:
            if (li, k) not in NOISE_ONLY:
                _close(layer[k], jlayer[k], (RTOL, ATOL), f"layer {li} {k}")


# ---------------------------------------------------------------------------
# The error bounds (the port's copy of analysis/error_bounds.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [0.0, 1e-4, 0.05, 0.3, 0.999, 1.0, 2.5])
def test_error_bounds_match_reference(eps):
    assert eb.thm3_coefficient_bound(eps) == jeb.thm3_coefficient_bound(eps)
    for heads in (1, 8):
        assert eb.thm4_layer1_bound(eps, heads) == jeb.thm4_layer1_bound(eps, heads)
        for layers in (1, 2, 3):
            assert eb.thm35_logit_bound(eps, layers, heads) == jeb.thm35_logit_bound(
                eps, layers, heads)


@pytest.mark.parametrize("basis", ["power", "chebyshev"])
@pytest.mark.parametrize("degree", [8, 16])
def test_series_envelope_matches_reference(basis, degree):
    cfg = FedGATConfig(degree=degree, basis=basis)
    got = eb.series_envelope(cfg.coeffs(), basis, cfg.domain)
    want = jeb.series_envelope(cfg.coeffs(), basis, cfg.domain)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_error_bounds_refuse_what_the_reference_refuses():
    for fn, args in ((eb.thm3_coefficient_bound, (-0.1,)), (eb.thm4_layer1_bound, (0.1, 0)),
                     (eb.thm35_logit_bound, (0.1, 0, 8))):
        with pytest.raises(ValueError):
            fn(*args)
    with pytest.raises(ValueError, match="unknown basis"):
        eb.series_envelope(np.ones(3), "legendre")
