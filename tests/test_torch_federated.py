"""The port's federated slice against the JAX package: partition, masks,
communication accounting, selection, optimizer and aggregation on
numpy-seeded inputs, and the vmap Trainer end to end on ``tiny`` with the
reference's own initial parameters.

Torch cannot reproduce ``jax.random`` bits, so every run here feeds the
port the initial params the reference's ``_run_vmap`` draws
(``k_pack, k_init = split(PRNGKey(seed))``, ``FedGAT(cfg).init(k_init, g)``).

One leaf is not held by value: the output layer's ``a1``. On ``tiny`` at
these params every layer-2 score ``s1_i + s2_j`` has one sign, so the
leaky ReLU is linear there and the softmax cannot see ``s1_i = z_i . a1``:
the logits do not depend on that leaf and its gradient is float32
rounding noise, which Adam scales into real steps in both packages (the
reference's own ``direct`` and ``kernel`` engines disagree on it under
fedprox). ``test_output_layer_a1_does_not_reach_the_logits`` proves the
property and ``test_the_reference_engines_disagree_only_where_rounding_decides``
the reference's own disagreement; the Trainer tests hold every other
leaf and the curves. Under fedadam the server's Adam (eps 1e-6) turns that noise into
+-server_lr steps and from round 2 on into every leaf, as between the
reference's own engines, so fedadam is held through its first round.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import FedGATConfig as JFedGATConfig
from repro.core.fedgat_model import FedGAT as JFedGAT
from repro.core.gat import masked_cross_entropy as j_masked_cross_entropy
from repro.core.gcn import init_gcn_params as j_init_gcn_params
from repro.federated import aggregation as jagg
from repro.federated import comm as jcomm
from repro.federated import partition as jpart
from repro.federated import trainer as jtrainer
from repro.graphs import make_cora_like as j_make_cora_like
from repro.graphs import make_sbm as j_make_sbm
from repro.optim.adamw import AdamState as JAdamState
from repro.optim.adamw import adam_init as j_adam_init
from repro.optim.adamw import adam_update as j_adam_update
from repro.serving import GraphInferenceServer as JServer
from repro.serving import Query as JQuery
from repro.serving import load_bundle as j_load_bundle
from repro.telemetry import config_hash as j_config_hash
from repro_torch.core import FedGATConfig, get_engine, layered_forward, params_from_numpy
from repro_torch.core.gat import masked_cross_entropy
from repro_torch.federated import aggregation as agg
from repro_torch.federated import comm
from repro_torch.federated import partition as part_mod
from repro_torch.federated import trainer
from repro_torch.federated.trainer import FederatedConfig, Trainer, run_federated, train_centralized
from repro_torch.graphs import make_cora_like, make_sbm
from repro_torch.launch import serve as serve_cli
from repro_torch.optim import AdamState, adam_init, adam_update
from repro_torch.privacy import PrivacyConfig
from repro_torch.serving import GraphInferenceServer, Query, load_bundle, save_bundle
from repro_torch.telemetry.manifest import reference_fields

torch.set_num_threads(1)

CPU = torch.device("cpu")
CURVE_ATOL = 1e-6
RTOL, ATOL = 1e-3, 1e-4              # final params (tests/test_kernel_engine.py:275-276)
GRAD_RTOL, GRAD_ATOL = 5e-3, 5e-4    # tests/test_kernel_engine.py:303-304
TIGHT = 1e-6                         # optimizer and aggregation steps


@pytest.fixture(scope="module")
def tiny():
    return make_cora_like("tiny", seed=0), j_make_cora_like("tiny", seed=0)


@pytest.fixture(scope="module")
def sbm1k():
    return make_sbm("sbm_1k", seed=0), j_make_sbm("sbm_1k", seed=0)


def _jax_init(jcfg, jg):
    """The initial params of the reference's ``_run_vmap`` for ``jcfg``."""
    _, k_init = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    if jcfg.method == "fedgcn":
        return j_init_gcn_params(k_init, jg.feature_dim, jcfg.gcn_hidden, jg.num_classes)
    return JFedGAT(jtrainer.method_model_config(jcfg)).init(k_init, jg)


def _numpy_tree(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _configs(**kw):
    model = kw.pop("model", {})
    return (FederatedConfig(model=FedGATConfig(**model), **kw),
            jtrainer.FederatedConfig(model=JFedGATConfig(**model), **kw))


def _assert_params_close(got, want, skip=()):
    for li, (layer, jlayer) in enumerate(zip(got, want)):
        assert set(layer.keys()) == set(jlayer.keys())
        for k in jlayer:
            if (li, k) in skip:
                continue
            got_k = layer[k].detach().numpy() if isinstance(layer[k], torch.Tensor) else layer[k]
            np.testing.assert_allclose(np.asarray(got_k), np.asarray(jlayer[k]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"layer {li} {k}")


def _assert_curves_equal(res, jres):
    np.testing.assert_allclose(res["val_curve"], jres["val_curve"], atol=CURVE_ATOL)
    np.testing.assert_allclose(res["test_curve"], jres["test_curve"], atol=CURVE_ATOL)


# ---------------------------------------------------------------------------
# Partition, masks, communication accounting, selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("graph", ["tiny", "sbm1k"])
@pytest.mark.parametrize("beta", [1.0, 1e4])
def test_partition_and_masks_are_bit_identical(graph, beta, request):
    g, jg = request.getfixturevalue(graph)
    K = 4
    p = part_mod.dirichlet_partition(g.labels, K, beta, seed=3)
    jp = jpart.dirichlet_partition(jg.labels, K, beta, seed=3)
    np.testing.assert_array_equal(p.owner, jp.owner)
    assert (p.num_clients, p.beta) == (jp.num_clients, jp.beta)
    np.testing.assert_array_equal(part_mod.client_neighbor_masks(g, p),
                                  jpart.client_neighbor_masks(jg, jp))
    np.testing.assert_array_equal(part_mod.client_neighbor_masks(g, p, clients=[2, 0]),
                                  jpart.client_neighbor_masks(jg, jp, clients=[2, 0]))
    np.testing.assert_array_equal(part_mod.client_train_masks(g, p),
                                  jpart.client_train_masks(jg, jp))
    assert part_mod.cross_client_edge_count(g, p) == jpart.cross_client_edge_count(jg, jp)
    np.testing.assert_array_equal(part_mod.l_hop_sizes(g, p, 2), jpart.l_hop_sizes(jg, jp, 2))
    for k in range(K):
        np.testing.assert_array_equal(part_mod.client_halo_nodes(g, p, k, 1),
                                      jpart.client_halo_nodes(jg, jp, k, 1))
    sub, jsub = part_mod.client_subgraph(g, p, 1, hops=1), jpart.client_subgraph(jg, jp, 1, hops=1)
    np.testing.assert_array_equal(sub.nodes, jsub.nodes)
    np.testing.assert_array_equal(sub.local_mask, jsub.local_mask)
    assert sub.num_halo == jsub.num_halo
    for field in ("features", "labels", "indptr", "indices", "nbr_idx", "nbr_mask",
                  "train_mask", "val_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(sub.graph, field), getattr(jsub.graph, field))


@pytest.mark.parametrize("method,engine", [
    ("fedgat", "direct"), ("fedgat", "kernel"), ("fedgat", "exact"),
    ("distgat", "direct"), ("fedgcn", "direct"),
])
@pytest.mark.parametrize("num_layers", [2, 3])
def test_comm_report_is_identical(tiny, method, engine, num_layers):
    g, jg = tiny
    cfg, jcfg = _configs(method=method, num_clients=3,
                         model=dict(engine=engine, num_layers=num_layers))
    p = part_mod.dirichlet_partition(g.labels, 3, 1.0, 0)
    jp = jpart.dirichlet_partition(jg.labels, 3, 1.0, 0)
    got, want = trainer.comm_report(cfg, g, p), jtrainer.comm_report(jcfg, jg, jp)
    if want is None:
        assert got is None
        return
    assert (got.upload_scalars, got.download_scalars, got.cross_client_edges) == (
        want.upload_scalars, want.download_scalars, want.cross_client_edges)
    np.testing.assert_array_equal(got.per_client, want.per_client)
    v, jv = comm.vector_comm_cost(g, p, num_layers), jcomm.vector_comm_cost(jg, jp, num_layers)
    assert v.download_scalars == jv.download_scalars


@pytest.mark.parametrize("K,frac,rounds", [
    (5, 0.5, 6), (4, 0.5, 5), (10, 0.3, 4), (7, 1.0, 3), (3, 0.1, 2), (9, 0.95, 3),
])
def test_selection_schedule_and_num_selected_are_identical(K, frac, rounds):
    cfg, jcfg = _configs(num_clients=K, client_fraction=frac, rounds=rounds, seed=4)
    assert trainer.num_selected(cfg) == jtrainer.num_selected(jcfg)
    if (K, frac) == (5, 0.5):
        assert trainer.num_selected(cfg) == 3      # half-up, not banker's rounding
    sel, chosen = trainer.selection_schedule(cfg)
    jsel, jchosen = jtrainer.selection_schedule(jcfg)
    np.testing.assert_array_equal(sel, jsel)
    np.testing.assert_array_equal(chosen, jchosen)
    assert chosen.dtype == jchosen.dtype and sel.dtype == jsel.dtype


def test_best_metrics_takes_the_first_best_round():
    val, test = [0.2, 0.5, 0.5, 0.1], [0.3, 0.6, 0.9, 0.2]
    assert trainer.best_metrics(val, test) == jtrainer.best_metrics(val, test) == (0.5, 0.6)
    assert trainer.best_metrics([], []) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# Optimizer, aggregation, loss
# ---------------------------------------------------------------------------

def _trees(seed, lead=()):
    rng = np.random.default_rng(seed)
    return [
        {"W": rng.standard_normal(lead + (2, 5, 3)).astype(np.float32),
         "a1": rng.standard_normal(lead + (2, 3)).astype(np.float32)},
        {"W": rng.standard_normal(lead + (4, 2)).astype(np.float32)},
    ]


def _torch_tree(tree):
    return [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in tree]


def _close_trees(got, want, tol=TIGHT):
    for layer, jlayer in zip(got, want):
        for k in jlayer:
            np.testing.assert_allclose(layer[k].numpy(), np.asarray(jlayer[k]), rtol=tol, atol=tol)


def test_adam_update_matches_reference():
    params, jparams = _torch_tree(_trees(0)), _trees(0)
    opt, jopt = adam_init(params), j_adam_init(jparams)
    assert opt.step.dtype == torch.int32
    for s in range(4):
        grads = _trees(10 + s)
        params, opt = adam_update(_torch_tree(grads), opt, params, 0.01, weight_decay=1e-3)
        jparams, jopt = j_adam_update(grads, jopt, jparams, 0.01, weight_decay=1e-3)
    _close_trees(params, jparams)
    _close_trees(opt.mu, jopt.mu)
    _close_trees(opt.nu, jopt.nu)
    assert int(opt.step) == int(jopt.step) == 4


def test_fedavg_fedprox_and_fedadam_match_reference():
    stacked, jstacked = _torch_tree(_trees(1, (4,))), _trees(1, (4,))
    _close_trees(agg.fedavg(stacked), jagg.fedavg(jstacked))
    w = np.array([1.0, 3.0, 0.0, 2.0], np.float32)
    _close_trees(agg.fedavg(stacked, torch.from_numpy(w)), jagg.fedavg(jstacked, jnp.asarray(w)))
    local, glob, grads = (_trees(s) for s in (2, 3, 4))
    _close_trees(agg.fedprox_grad(*map(_torch_tree, (local, glob, grads)), 0.01),
                 jagg.fedprox_grad(local, glob, grads, 0.01))
    gp, jgp = _torch_tree(glob), glob
    state, jstate = adam_init(gp), j_adam_init(jgp)
    for s in range(3):
        clients = _trees(20 + s, (4,))
        gp, state = agg.fedadam_server(gp, _torch_tree(clients), state, 0.05)
        jgp, jstate = jagg.fedadam_server(jgp, clients, jstate, 0.05)
    _close_trees(gp, jgp)
    _close_trees(state.nu, jstate.nu)
    assert isinstance(state, AdamState) and isinstance(jstate, JAdamState)


def test_masked_cross_entropy_matches_reference():
    rng = np.random.default_rng(5)
    logits = (3 * rng.standard_normal((40, 7))).astype(np.float32)
    labels = rng.integers(0, 7, 40).astype(np.int32)
    for mask in (rng.random(40) < 0.4, np.zeros(40, bool)):
        got = masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   torch.from_numpy(mask))
        want = j_masked_cross_entropy(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
        np.testing.assert_allclose(float(got), float(want), rtol=TIGHT, atol=TIGHT)


# ---------------------------------------------------------------------------
# The local step and the Trainer end to end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method,engine", [
    ("fedgat", "direct"), ("fedgat", "kernel"), ("distgat", "direct"), ("fedgcn", "direct"),
])
def test_first_local_step_gradients_match_jax_grad(tiny, method, engine):
    g, jg = tiny
    cfg, jcfg = _configs(method=method, num_clients=4, model=dict(engine=engine, degree=10))
    p = part_mod.dirichlet_partition(g.labels, 4, 1.0, 0)
    jp = jpart.dirichlet_partition(jg.labels, 4, 1.0, 0)
    jparams = _jax_init(jcfg, jg)
    _, jforward = jtrainer.build_forward(jcfg, jg, jax.random.PRNGKey(0))
    jnb, jtr = jtrainer.client_masks(jcfg, jg, jp)
    jloss = jtrainer.make_loss_fn(jforward, jnp.asarray(jg.labels))
    _, forward = trainer.build_forward(cfg, g, CPU)
    nb, tr = trainer.client_masks(cfg, g, p, CPU)
    loss = trainer.make_loss_fn(forward, torch.as_tensor(g.labels, dtype=torch.int64))
    params = trainer.param_tree(params_from_numpy(_numpy_tree(jparams), device=CPU))
    for c in range(4):
        jgrads = jax.grad(jloss)(jparams, jnb[c], jtr[c])
        grads = trainer.grad_of(loss, params, nb[c].contiguous(), tr[c])
        for layer, jlayer in zip(grads, jgrads):
            for k in jlayer:
                np.testing.assert_allclose(layer[k].numpy(), np.asarray(jlayer[k]),
                                           rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"client {c} {k}")


def test_output_layer_a1_does_not_reach_the_logits(tiny):
    """Why the Trainer tests do not hold the output layer's ``a1``: in
    float64, moving it by up to 2.0 leaves every logit in place, and its
    gradient is zero, while the other leaves' gradients are not."""
    g, jg = tiny
    cfg = FedGATConfig(engine="direct", degree=10)
    jparams = _jax_init(jtrainer.FederatedConfig(model=JFedGATConfig(degree=10)), jg)
    f64 = [{k: torch.tensor(np.asarray(v), dtype=torch.float64) for k, v in l.items()}
           for l in jparams]
    engine = get_engine("direct")(cfg)
    coeffs = torch.tensor(cfg.coeffs(), dtype=torch.float64)
    h = torch.tensor(g.features, dtype=torch.float64)
    idx, mask = torch.tensor(g.nbr_idx).long(), torch.tensor(g.nbr_mask)
    labels = torch.tensor(g.labels).long()

    def logits(p):
        return layered_forward(engine, p, coeffs, None, h, idx, mask)

    base = logits(f64)
    for shift in (0.1, 2.0):
        moved = [dict(l) for l in f64]
        moved[1]["a1"] = moved[1]["a1"] + shift
        assert float((logits(moved) - base).abs().max()) < 1e-12
    grads = trainer.grad_of(
        lambda p: masked_cross_entropy(logits(p), labels, torch.tensor(g.train_mask)), f64)
    assert float(grads[1]["a1"].abs().max()) < 1e-15
    assert float(grads[1]["a2"].abs().max()) > 1e-6 and float(grads[1]["W"].abs().max()) > 1e-6


NOISE_ONLY = {(1, "a1")}      # see the module docstring


def test_the_reference_engines_disagree_only_where_rounding_decides(tiny):
    """The reference against itself: its ``direct`` and ``kernel`` engines
    compute the same function with other roundings. Under fedprox they
    disagree on the gradient-free leaf alone; under fedadam on other
    leaves too, and on a curve."""
    _, jg = tiny

    def pair(aggregator):
        return [jtrainer.run_federated(jg, jtrainer.FederatedConfig(
            num_clients=4, rounds=3, local_steps=2, aggregator=aggregator,
            client_fraction=0.5, model=JFedGATConfig(engine=engine, degree=10)))
            for engine in ("direct", "kernel")]

    direct, kernel = pair("fedprox")
    _assert_params_close(direct["params"], kernel["params"], skip=NOISE_ONLY)
    assert not np.allclose(direct["params"][1]["a1"], kernel["params"][1]["a1"],
                           rtol=RTOL, atol=ATOL)
    direct, kernel = pair("fedadam")
    assert not np.allclose(direct["params"][0]["W"], kernel["params"][0]["W"],
                           rtol=RTOL, atol=ATOL)
    assert direct["val_curve"] != kernel["val_curve"] or (
        direct["test_curve"] != kernel["test_curve"])


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("engine", ["direct", "kernel"])
@pytest.mark.parametrize("aggregator", ["fedavg", "fedprox"])
def test_run_federated_matches_the_jax_vmap_trainer(tiny, aggregator, engine, fraction):
    g, jg = tiny
    cfg, jcfg = _configs(num_clients=4, rounds=3, local_steps=2, aggregator=aggregator,
                         client_fraction=fraction, model=dict(engine=engine, degree=10))
    jres = jtrainer.run_federated(jg, jcfg)
    res = run_federated(g, cfg, device=CPU, params=_numpy_tree(_jax_init(jcfg, jg)))
    _assert_curves_equal(res, jres)
    _assert_params_close(res["params"], jres["params"], skip=NOISE_ONLY)
    np.testing.assert_array_equal(res["partition"].owner, jres["partition"].owner)
    assert res["comm"].download_scalars == jres["comm"].download_scalars
    assert (res["best_val"], res["best_test"]) == pytest.approx((jres["best_val"], jres["best_test"]))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
@pytest.mark.parametrize("engine", ["direct", "kernel"])
def test_fedadam_first_round_matches_the_jax_vmap_trainer(tiny, engine, fraction):
    g, jg = tiny
    cfg, jcfg = _configs(num_clients=4, rounds=1, local_steps=2, aggregator="fedadam",
                         client_fraction=fraction, model=dict(engine=engine, degree=10))
    jres = jtrainer.run_federated(jg, jcfg)
    res = run_federated(g, cfg, device=CPU, params=_numpy_tree(_jax_init(jcfg, jg)))
    _assert_curves_equal(res, jres)
    _assert_params_close(res["params"], jres["params"], skip=NOISE_ONLY)


@pytest.mark.parametrize("method", ["distgat", "fedgcn"])
def test_baseline_methods_match_the_jax_vmap_trainer(tiny, method):
    g, jg = tiny
    cfg, jcfg = _configs(method=method, num_clients=4, rounds=3, local_steps=2,
                         model=dict(degree=10))
    jres = jtrainer.run_federated(jg, jcfg)
    res = run_federated(g, cfg, device=CPU, params=_numpy_tree(_jax_init(jcfg, jg)))
    _assert_curves_equal(res, jres)
    _assert_params_close(res["params"], jres["params"])
    assert res["comm"] is None and jres["comm"] is None


def test_result_has_the_reference_schema(tiny):
    g, jg = tiny
    cfg, jcfg = _configs(num_clients=2, rounds=1, local_steps=1,
                         model=dict(engine="kernel", degree=10))
    res = run_federated(g, cfg, device=CPU)
    jres = jtrainer.run_federated(jg, jcfg)
    assert set(res) == set(jres)
    assert res["privacy"] == jres["privacy"]
    assert res["epsilon"] is None and res["backend"] == "vmap"
    assert res["mesh"] is None and res["cohort"] is None
    assert res["manifest"]["config_hash"] == jres["manifest"]["config_hash"]
    assert res["manifest"]["backend"] == jres["manifest"]["backend"] == "vmap"
    assert all(torch.isfinite(p).all() for p in res["params"].parameters())


def test_default_params_come_from_a_torch_generator(tiny):
    g, _ = tiny
    cfg, _ = _configs(num_clients=2, rounds=2, local_steps=1, model=dict(engine="direct"))
    a, b = (run_federated(g, cfg, device=CPU) for _ in range(2))
    assert a["val_curve"] == b["val_curve"]
    for p, q in zip(a["params"].parameters(), b["params"].parameters()):
        assert torch.equal(p, q)


def test_train_centralized_gat_matches_reference(tiny):
    g, jg = tiny
    jres = jtrainer.train_centralized(jg, "gat", steps=4)
    _, k_init = jax.random.split(jax.random.PRNGKey(0))
    init = JFedGAT(JFedGATConfig(engine="exact")).init(k_init, jg)
    res = train_centralized(g, "gat", steps=4, device=CPU, params=_numpy_tree(init))
    _assert_curves_equal(res, jres)
    _assert_params_close(res["params"], jres["params"])
    gcn = train_centralized(g, "gcn", steps=2, device=CPU)
    assert len(gcn["val_curve"]) == 2 and np.isfinite(gcn["final_test"])


# ---------------------------------------------------------------------------
# Bundles, the serve CLI, refusals
# ---------------------------------------------------------------------------

def test_port_bundle_loads_and_serves_in_both_packages(tiny, tmp_path):
    g, jg = tiny
    cfg, jcfg = _configs(num_clients=2, rounds=2, local_steps=1,
                         model=dict(engine="kernel", degree=10))
    res = run_federated(g, cfg, device=CPU)
    path = save_bundle(str(tmp_path / "b"), res["params"], cfg, step=2)
    jb = j_load_bundle(str(path), jg)
    tb = load_bundle(str(path), g, device=CPU)
    assert jb.meta["manifest"] == tb.meta["manifest"] and jb.meta["step"] == 2
    assert jb.meta["manifest"]["config_hash"] == j_config_hash(jcfg)
    assert dataclasses.asdict(jb.model) == reference_fields(tb.model)
    assert jb.privacy.noise_multiplier == 0.0 and not jb.privacy.enabled
    for layer, jlayer, tlayer in zip(res["params"], jb.params, tb.params):
        for k in ("W", "a1", "a2"):
            np.testing.assert_array_equal(np.asarray(jlayer[k]), layer[k].detach().numpy())
            np.testing.assert_array_equal(tlayer[k].detach().numpy(), layer[k].detach().numpy())
    qs = [(c, n) for c in (0, 1) for n in range(0, g.num_nodes, 3)]
    got = GraphInferenceServer.from_checkpoint(str(path), g, device=CPU).serve_batch(
        [Query(c, n) for c, n in qs])
    want = JServer.from_checkpoint(str(path), jg).serve_batch([JQuery(c, n) for c, n in qs])
    assert [r.label for r in got] == [r.label for r in want]
    np.testing.assert_allclose(np.stack([r.logits for r in got]),
                               np.stack([r.logits for r in want]), rtol=1e-4, atol=1e-5)


def test_serve_cli_quick_trains_and_serves_on_cpu(capsys):
    serve_cli.main(["--mode", "graph", "--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "trained: method=fedgat engine=matrix rounds=2" in out
    assert "serving: engine=matrix method=fedgat clients=2" in out
    assert "served: 48 queries" in out and "post-update: served 4" in out


@pytest.mark.parametrize("overrides,error", [
    (dict(max_concurrent_clients=0), ValueError),
    (dict(aggregation_mode="buffered", churn_drop_rate=0.1,
          privacy=PrivacyConfig(noise_multiplier=1.0, clip=1.0)), ValueError),
    (dict(aggregation_mode="buffered", churn_join_rate=0.1,
          privacy=PrivacyConfig(secure_agg=True)), ValueError),
    (dict(privacy=PrivacyConfig(pack_noise_multiplier=0.5)), ValueError),
    (dict(method="fedgcn", privacy=PrivacyConfig(pack_noise_multiplier=0.5)), ValueError),
    (dict(backend="pmap"), ValueError),
    (dict(client_fraction=0.0), ValueError),
    (dict(aggregation_mode="async"), ValueError),
    (dict(max_concurrent_clients=9), ValueError),
    (dict(churn_drop_rate=0.1), ValueError),
    (dict(privacy=PrivacyConfig(noise_multiplier=1.0)), ValueError),
    (dict(method="fedsage"), ValueError),
])
def test_unsupported_configs_raise(overrides, error):
    base = dict(num_clients=4, model=FedGATConfig(engine="kernel"))
    base.update(overrides)
    with pytest.raises(error):
        Trainer(FederatedConfig(**base), device=CPU)


def test_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(FederatedConfig(model=FedGATConfig(engine="kernel")))

