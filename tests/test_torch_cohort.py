"""The port's cohort streaming against the JAX package: the host planning
and mask staging bit for bit, the running aggregate against ``fedavg``,
and cohort-streamed runs on ``tiny`` against the reference's own cohort
runs and against the port's Trainer loop, with the reference's initial
params (and pack) fed through ``params=``/``pack=``.

The reference's tolerances (``tests/test_cohort.py``): sync cohort runs
agree with the one-lane-per-client loop at 1e-6 on the curves; final
params are held at rtol 1e-3 / atol 1e-4 as in
``tests/test_torch_federated.py``, skipping the GAT output layer's ``a1``
against the reference: its gradient is rounding noise on ``tiny`` at the
reference's initial params (that file's docstring), for distgat too.
Buffered mode with ``staleness_power=0`` and no churn equals sync mode
bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import FedGATConfig as JFedGATConfig
from repro.core.fedgat_model import FedGAT as JFedGAT
from repro.core.gcn import init_gcn_params as j_init_gcn_params
from repro.federated import aggregation as jagg
from repro.federated import cohort as jcohort
from repro.federated import partition as jpart
from repro.federated import trainer as jtrainer
from repro.graphs import make_cora_like as j_make_cora_like
from repro_torch import telemetry
from repro_torch.core import FedGATConfig
from repro_torch.federated import aggregation as agg
from repro_torch.federated import cohort
from repro_torch.federated import partition as part_mod
from repro_torch.federated import trainer
from repro_torch.federated.trainer import FederatedConfig, run_federated
from repro_torch.graphs import make_cora_like

torch.set_num_threads(1)

CPU = torch.device("cpu")
CURVE_ATOL = 1e-6                    # tests/test_cohort.py:160
RTOL, ATOL = 1e-3, 1e-4              # final params, as tests/test_torch_federated.py
TIGHT = 1e-6                         # the running mean against fedavg
NOISE_ONLY = {(1, "a1")}             # see tests/test_torch_federated.py


@pytest.fixture(scope="module")
def tiny():
    return make_cora_like("tiny", seed=0), j_make_cora_like("tiny", seed=0)


def _configs(**kw):
    model = kw.pop("model", {})
    return (FederatedConfig(model=FedGATConfig(**model), **kw),
            jtrainer.FederatedConfig(model=JFedGATConfig(**model), **kw))


def _numpy_tree(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _reference_start(jcfg, jg):
    """The initial params (and pack) the reference's drivers draw for
    ``jcfg``: ``k_pack, k_init = split(PRNGKey(seed))``."""
    k_pack, k_init = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    if jcfg.method == "fedgcn":
        return _numpy_tree(j_init_gcn_params(
            k_init, jg.feature_dim, jcfg.gcn_hidden, jg.num_classes)), None
    model = JFedGAT(jtrainer.method_model_config(jcfg))
    pack = model.precommunicate(k_pack, jg)
    return _numpy_tree(model.init(k_init, jg)), pack


def _assert_curves_close(a, b):
    np.testing.assert_allclose(a["val_curve"], b["val_curve"], atol=CURVE_ATOL)
    np.testing.assert_allclose(a["test_curve"], b["test_curve"], atol=CURVE_ATOL)


def _assert_params_close(got, want, skip=()):
    for li, (layer, wlayer) in enumerate(zip(got, want)):
        assert set(layer.keys()) == set(wlayer.keys())
        for k in wlayer:
            if (li, k) in skip:
                continue
            w = wlayer[k]
            w = w.detach().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
            np.testing.assert_allclose(layer[k].detach().numpy(), w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"layer {li} {k}")


# ---------------------------------------------------------------------------
# Host planning and staging: bit for bit
# ---------------------------------------------------------------------------

PLAN_CASES = [
    dict(num_clients=10, client_fraction=0.5, rounds=3),
    dict(num_clients=8, client_fraction=0.5, rounds=6, seed=3, max_concurrent_clients=3),
    dict(num_clients=9, client_fraction=1.0, rounds=2, aggregation_mode="buffered",
         staleness_power=0.5, max_concurrent_clients=3),
    dict(num_clients=20, client_fraction=0.5, rounds=4, aggregation_mode="buffered",
         churn_drop_rate=0.4, churn_join_rate=0.3, max_concurrent_clients=4),
    dict(num_clients=16, client_fraction=1.0, rounds=5, seed=1, aggregation_mode="buffered",
         churn_drop_rate=0.25, max_concurrent_clients=4),
]


@pytest.mark.parametrize("kw", PLAN_CASES)
def test_plans_are_bit_identical(kw):
    cfg, jcfg = _configs(**kw)
    assert cohort.cohort_active(cfg) == jcohort.cohort_active(jcfg)
    lanes = cohort.cohort_lanes(cfg, "vmap")
    assert lanes == jcohort.cohort_lanes(jcfg, "vmap")
    _, chosen = trainer.selection_schedule(cfg)
    plans = cohort.plan_rounds(cfg, chosen, lanes)
    jplans = jcohort.plan_rounds(jcfg, jtrainer.selection_schedule(jcfg)[1], lanes)
    assert len(plans) == len(jplans) == cfg.rounds
    for p, jp in zip(plans, jplans):
        for field in ("ids", "weights", "sel_row", "staleness"):
            got, want = getattr(p, field), getattr(jp, field)
            np.testing.assert_array_equal(got, want, err_msg=field)
            assert got.dtype == want.dtype, field
        assert (p.joined, p.dropped) == (jp.joined, jp.dropped)
    one = cohort.plan_round(cfg, chosen[0], lanes, None)
    jone = jcohort.plan_round(jcfg, chosen[0], lanes, None)
    np.testing.assert_array_equal(one.ids, jone.ids)
    np.testing.assert_array_equal(one.staleness, jone.staleness)


@pytest.mark.parametrize("ids,size", [([2, 0], 2), ([3], 3), ([1, 3, 0], 4)])
@pytest.mark.parametrize("neighbor", [True, False])
def test_stage_cohort_masks_is_bit_identical(tiny, ids, size, neighbor):
    g, jg = tiny
    p = part_mod.dirichlet_partition(g.labels, 4, 1.0, 0)
    jp = jpart.dirichlet_partition(jg.labels, 4, 1.0, 0)
    nb, tr = part_mod.stage_cohort_masks(g, p, ids, size, neighbor=neighbor)
    jnb, jtr = jpart.stage_cohort_masks(jg, jp, ids, size, neighbor=neighbor)
    np.testing.assert_array_equal(tr, jtr)
    if neighbor:
        np.testing.assert_array_equal(nb, jnb)
        assert nb.shape == (size, g.num_nodes, g.max_degree)
    else:
        assert nb is None and jnb is None
    with pytest.raises(ValueError):
        part_mod.stage_cohort_masks(g, p, [0, 1, 2], 2)


def test_stager_memo_is_bounded_and_moves_masks_to_the_device(tiny):
    g, _ = tiny
    p = part_mod.dirichlet_partition(g.labels, 6, 1.0, 0)
    stager = cohort._CohortStager(g, p, lanes=2, per_client_nb=True, capacity=2, device=CPU)
    first = stager([0, 1])
    assert isinstance(first[0], torch.Tensor) and first[0].shape == (2, g.num_nodes, g.max_degree)
    assert stager([0, 1]) is first
    for ids in ([2, 3], [4, 5], [1]):
        stager(ids)
    assert len(stager._memo) == 2
    assert stager([0, 1]) is not first
    np.testing.assert_array_equal(stager([0, 1])[1].numpy(), first[1].numpy())


# ---------------------------------------------------------------------------
# The running aggregate
# ---------------------------------------------------------------------------

def _stacked(seed, n):
    rng = np.random.default_rng(seed)
    return [{"W": rng.standard_normal((n, 3, 5, 2)).astype(np.float32),
             "a1": rng.standard_normal((n, 3, 2)).astype(np.float32)},
            {"W": rng.standard_normal((n, 4, 2)).astype(np.float32)}]


def _torch(tree):
    return [{k: torch.from_numpy(v) for k, v in layer.items()} for layer in tree]


@pytest.mark.parametrize("chunks", [(6,), (2, 2, 2), (4, 1, 1), (1,) * 6])
def test_running_mean_equals_fedavg(chunks):
    stacked = _stacked(0, sum(chunks))
    want = agg.fedavg(_torch(stacked))
    state = agg.running_init([{k: torch.from_numpy(v[0]) for k, v in layer.items()}
                              for layer in stacked])
    jstate = jagg.running_init([{k: jnp.asarray(v[0]) for k, v in layer.items()}
                                for layer in stacked])
    lo = 0
    for n in chunks:
        part = [{k: v[lo:lo + n] for k, v in layer.items()} for layer in stacked]
        w = np.ones(n, np.float32)
        state = agg.running_update(state, _torch(part), w)
        jstate = jagg.running_update(jstate, part, jnp.asarray(w))
        lo += n
    got = agg.running_mean(state)
    jgot = jagg.running_mean(jstate)
    assert float(state.weight) == float(jstate.weight) == sum(chunks)
    for layer, wl, jl in zip(got, want, jgot):
        for k in wl:
            np.testing.assert_allclose(layer[k].numpy(), wl[k].numpy(), rtol=TIGHT, atol=TIGHT)
            np.testing.assert_allclose(layer[k].numpy(), np.asarray(jl[k]), rtol=TIGHT, atol=TIGHT)


def test_staleness_weighted_update_matches_reference():
    stacked = _stacked(1, 3)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    state = agg.running_init([{k: torch.from_numpy(v[0]) for k, v in l.items()} for l in stacked])
    jstate = jagg.running_init([{k: jnp.asarray(v[0]) for k, v in l.items()} for l in stacked])
    for lam in (1.0, 0.5 ** 0.5):
        state = agg.running_update(state, _torch(stacked), w, scale=lam)
        jstate = jagg.running_update(jstate, stacked, jnp.asarray(w), scale=lam)
    np.testing.assert_allclose(float(state.weight), float(jstate.weight), rtol=TIGHT)
    for layer, jl in zip(agg.running_mean(state), jagg.running_mean(jstate)):
        for k in jl:
            np.testing.assert_allclose(layer[k].numpy(), np.asarray(jl[k]), rtol=TIGHT, atol=TIGHT)
    for power in (0.0, 0.5, 2.0):
        np.testing.assert_array_equal(agg.staleness_weight(np.arange(5), power).numpy(),
                                      np.asarray(jagg.staleness_weight(np.arange(5), power)))


# ---------------------------------------------------------------------------
# Cohort-streamed runs against the reference and the Trainer's loop
# ---------------------------------------------------------------------------

RUN_CASES = [
    ("fedgat", "kernel", "fedavg"), ("fedgat", "kernel", "fedprox"),
    ("fedgat", "matrix", "fedavg"), ("distgat", "kernel", "fedavg"),
    ("fedgcn", "kernel", "fedavg"),
]


@pytest.mark.parametrize("lanes", [1, 2, 3])
@pytest.mark.parametrize("method,engine,aggregator", RUN_CASES)
def test_sync_cohorts_match_the_reference_and_the_loop(tiny, method, engine, aggregator, lanes):
    g, jg = tiny
    kw = dict(method=method, num_clients=6, rounds=3, local_steps=2, aggregator=aggregator,
              client_fraction=0.5, model=dict(engine=engine, degree=10))
    cfg, jcfg = _configs(**kw, max_concurrent_clients=lanes)
    params, pack = _reference_start(jcfg, jg)
    jres = jtrainer.run_federated(jg, jcfg)
    res = run_federated(g, cfg, device=CPU, params=params, pack=pack)
    loop = run_federated(g, dataclasses.replace(cfg, max_concurrent_clients=None), device=CPU,
                         params=params, pack=pack)
    _assert_curves_close(res, jres)
    _assert_params_close(res["params"], jres["params"], NOISE_ONLY)
    _assert_curves_close(res, loop)
    _assert_params_close(res["params"], loop["params"])
    assert res["cohort"] == jres["cohort"]
    assert loop["cohort"] is None and set(res) == set(jres)
    assert res["cohort"]["lanes"] == lanes


def test_fedadam_first_round_matches_the_reference(tiny):
    g, jg = tiny
    cfg, jcfg = _configs(num_clients=6, rounds=1, local_steps=2, aggregator="fedadam",
                         client_fraction=0.5, max_concurrent_clients=2,
                         model=dict(engine="kernel", degree=10))
    params, _ = _reference_start(jcfg, jg)
    res = run_federated(g, cfg, device=CPU, params=params)
    jres = jtrainer.run_federated(jg, jcfg)
    _assert_curves_close(res, jres)
    _assert_params_close(res["params"], jres["params"], NOISE_ONLY)


def test_buffered_with_power_zero_is_bit_identical_to_sync(tiny):
    g, _ = tiny
    cfg, _ = _configs(num_clients=6, rounds=3, local_steps=2, client_fraction=0.75,
                      max_concurrent_clients=2, model=dict(engine="kernel", degree=10))
    sync = run_federated(g, cfg, device=CPU)
    buf = run_federated(g, dataclasses.replace(cfg, aggregation_mode="buffered",
                                               staleness_power=0.0), device=CPU)
    assert sync["val_curve"] == buf["val_curve"] and sync["test_curve"] == buf["test_curve"]
    for p, q in zip(sync["params"].parameters(), buf["params"].parameters()):
        assert torch.equal(p, q)
    assert buf["cohort"]["mode"] == "buffered" and sync["cohort"]["mode"] == "sync"


def test_buffered_churn_matches_the_reference_and_counts(tiny):
    g, jg = tiny
    cfg, jcfg = _configs(num_clients=8, rounds=3, local_steps=2, client_fraction=0.75,
                         max_concurrent_clients=2, aggregation_mode="buffered",
                         staleness_power=0.5, churn_drop_rate=0.3, churn_join_rate=0.2,
                         model=dict(engine="kernel", degree=10))
    params, _ = _reference_start(jcfg, jg)
    joined = telemetry.counter("federated.cohort.joined").value
    dropped = telemetry.counter("federated.cohort.dropped").value
    res = run_federated(g, cfg, device=CPU, params=params)
    jres = jtrainer.run_federated(jg, jcfg)
    _assert_curves_close(res, jres)
    _assert_params_close(res["params"], jres["params"], NOISE_ONLY)
    assert res["cohort"] == jres["cohort"]
    assert res["cohort"]["joined"] + res["cohort"]["dropped"] > 0
    assert telemetry.counter("federated.cohort.joined").value - joined == res["cohort"]["joined"]
    assert (telemetry.counter("federated.cohort.dropped").value - dropped
            == res["cohort"]["dropped"])


def test_zero_rounds_and_unported_backends(tiny):
    g, jg = tiny
    cfg, jcfg = _configs(num_clients=4, rounds=0, max_concurrent_clients=2,
                         model=dict(engine="kernel", degree=10))
    res = run_federated(g, cfg, device=CPU)
    jres = jtrainer.run_federated(jg, jcfg)
    assert res["cohort"] == jres["cohort"] and res["val_curve"] == []
    # The shard_map backend is ported: one process drives one device, so
    # its cohorts have one lane.
    assert cohort.cohort_lanes(cfg, "shard_map") == 1
    run_cfg = dataclasses.replace(cfg, rounds=2)
    shard = cohort.run_cohort_rounds(g, run_cfg, backend="shard_map", device=CPU)
    loop = cohort.run_cohort_rounds(g, run_cfg, backend="vmap", device=CPU)
    assert shard["cohort"]["lanes"] == 1 and shard["cohort"]["cohorts_per_round"] == 4
    assert shard["mesh"] == {"axis_names": ["lanes"], "axis_sizes": [1], "num_devices": 1,
                             "num_processes": 1, "platform": "cpu"}
    _assert_curves_close(shard, loop)
