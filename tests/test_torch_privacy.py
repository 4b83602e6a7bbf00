"""The port's privacy stack against the JAX package.

Held exactly or bit for bit: the accountant, Shamir sharing, the
protocol's DH key material, field masks, quantization and
``SecureAggRound`` payloads and ``finalize`` (dropout recovery included)
on identical float64 vectors, the pack sensitivities on the reference's
own packs, ``privacy_report`` field by field, the MIA attack functions on
the same scores, and the configurations the reference refuses.

Torch cannot reproduce ``jax.random`` bits, so the PRF streams (DP noise,
pairwise masks, pack noise) are held to the reference's properties and
statistics, not its bits: the noise has the calibrated std and is
deterministic in its seed, the pairwise masks cancel over the selected
set (1e-4, ``tests/test_aggregation_numerics.py:223``), and a round with
secure aggregation on equals the round with it off to 1e-5
(``tests/test_privacy.py:354-362``). Runs that draw no noise (clip-only
DP, the protocol) are held against the reference's runs at the
tolerances of ``tests/test_torch_federated.py``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import FedGATConfig as JFedGATConfig
from repro.core.fedgat_model import FedGAT as JFedGAT
from repro.federated import trainer as jtrainer
from repro.graphs import make_cora_like as j_make_cora_like
from repro.optim.adamw import clip_by_global_norm as j_clip_by_global_norm
from repro.privacy import PrivacyConfig as JPrivacyConfig
from repro.privacy import accountant as jacc
from repro.privacy import pack_dp as jpack_dp
from repro.privacy import privacy_report as j_privacy_report
from repro.privacy import secure_agg as jsa
from repro.privacy import shamir as jshamir
from repro.privacy.attacks import mia as jmia
from repro_torch import telemetry
from repro_torch.core import FedGATConfig, pack_from_numpy
from repro_torch.federated import aggregation as agg
from repro_torch.federated.trainer import FederatedConfig, Trainer, run_federated
from repro_torch.graphs import make_cora_like
from repro_torch.optim import clip_by_global_norm
from repro_torch.privacy import (
    PrivacyConfig,
    accountant,
    add_client_mask,
    client_mask,
    client_round_key,
    flatten_pytree,
    make_dp_transform,
    mask_base_key,
    noise_base_key,
    noisy_pack,
    pack_noise_key,
    pack_sensitivities,
    per_client_noise_std,
    privacy_report,
    tree_add_normal,
)
from repro_torch.privacy import pack_dp, secure_agg, shamir
from repro_torch.privacy.attacks import mia

torch.set_num_threads(1)

CPU = torch.device("cpu")
CURVE_ATOL = 1e-6
RTOL, ATOL = 1e-3, 1e-4              # final params, as tests/test_torch_federated.py
NOISE_ONLY = {(1, "a1")}             # see tests/test_torch_federated.py
MASK_ATOL = 1e-4                     # tests/test_aggregation_numerics.py:223
EXACT_ROUND = 1e-5                   # tests/test_privacy.py:354-362


@pytest.fixture(scope="module")
def tiny():
    return make_cora_like("tiny", seed=0), j_make_cora_like("tiny", seed=0)


def _configs(priv=None, **kw):
    model = kw.pop("model", dict(engine="kernel", degree=10))
    priv = priv or {}
    return (FederatedConfig(model=FedGATConfig(**model), privacy=PrivacyConfig(**priv), **kw),
            jtrainer.FederatedConfig(model=JFedGATConfig(**model),
                                     privacy=JPrivacyConfig(**priv), **kw))


def _reference_start(jcfg, jg):
    k_pack, k_init = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    model = JFedGAT(jtrainer.method_model_config(jcfg))
    pack = model.precommunicate(k_pack, jg)
    return [{k: np.asarray(v) for k, v in l.items()} for l in model.init(k_init, jg)], pack


def _param_diff(a, b):
    return max(float((p.detach() - q.detach()).abs().max())
               for p, q in zip(a.parameters(), b.parameters()))


def _assert_params_close(got, want, skip=NOISE_ONLY):
    for li, (layer, jlayer) in enumerate(zip(got, want)):
        for k in jlayer:
            if (li, k) not in skip:
                np.testing.assert_allclose(layer[k].detach().numpy(), np.asarray(jlayer[k]),
                                           rtol=RTOL, atol=ATOL, err_msg=f"layer {li} {k}")


# ---------------------------------------------------------------------------
# The accountant and Shamir: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q", [0.01, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("sigma", [0.5, 1.0, 3.0])
def test_accountant_values_are_exact(q, sigma):
    for order in (2, 5, 32, 256):
        assert accountant.rdp_sampled_gaussian(q, sigma, order) == \
            jacc.rdp_sampled_gaussian(q, sigma, order)
    for steps in (0, 1, 60):
        for sens in (1.0, 2.0):
            assert accountant.compute_epsilon(sigma, steps, q, 1e-5, sensitivity=sens) == \
                jacc.compute_epsilon(sigma, steps, q, 1e-5, sensitivity=sens)
    acct, jacct = accountant.RdpAccountant(), jacc.RdpAccountant()
    for a in (acct, jacct):
        a.step(sigma, q, steps=7)
        a.step(sigma * 2, q / 2)
    assert acct.get_epsilon(1e-6) == jacct.get_epsilon(1e-6)
    assert accountant.DEFAULT_ORDERS == jacc.DEFAULT_ORDERS
    assert accountant.compute_epsilon(0.0, 3, q, 1e-5) == jacc.compute_epsilon(0.0, 3, q, 1e-5)


def test_shamir_shares_are_bit_identical():
    secret = 0x1234_5678_9ABC_DEF0 << 190
    xs = [c + 1 for c in (0, 2, 3, 7, 9)]
    for t in (1, 3, 5):
        shares = shamir.share_secret(secret, xs, t, b"tag")
        assert shares == jshamir.share_secret(secret, xs, t, b"tag")
        held = dict(list(shares.items())[:t])
        assert shamir.reconstruct_secret(held, t) == jshamir.reconstruct_secret(held, t) == secret
    assert shamir.SHARE_PRIME == jshamir.SHARE_PRIME
    with pytest.raises(ValueError):
        shamir.reconstruct_secret(dict(list(shares.items())[:2]), 3)


# ---------------------------------------------------------------------------
# The protocol half of secure aggregation: bit for bit
# ---------------------------------------------------------------------------

def test_key_material_masks_and_quantization_are_bit_identical():
    for c in (0, 3, 11):
        s = secure_agg.dh_secret(7, 2, 0, c)
        assert s == jsa.dh_secret(7, 2, 0, c)
        assert secure_agg.dh_public(s) == jsa.dh_public(s)
    a, b = secure_agg.dh_secret(7, 2, 0, 1), secure_agg.dh_secret(7, 2, 0, 4)
    shared = secure_agg.dh_shared(a, secure_agg.dh_public(b))
    assert shared == jsa.dh_shared(b, jsa.dh_public(a))
    seed = secure_agg.pair_seed(shared, 4, 1, 2, 0)
    assert seed == jsa.pair_seed(shared, 1, 4, 2, 0)
    np.testing.assert_array_equal(secure_agg.mask_vector(seed, 257), jsa.mask_vector(seed, 257))
    vec = np.random.default_rng(0).normal(scale=10.0, size=300)
    vec[:3] = (40.0, -33.0, 32.0)
    for bits, rng in ((32, 32.0), (16, 1.0)):
        q, sat = secure_agg.quantize(vec, bits, rng)
        jq, jsat = jsa.quantize(vec, bits, rng)
        np.testing.assert_array_equal(q, jq)
        assert sat == jsat
        np.testing.assert_array_equal(secure_agg.dequantize_sum(q * 3, 3, bits, rng),
                                      jsa.dequantize_sum(jq * 3, 3, bits, rng))
        assert secure_agg.quantization_step(bits, rng) == jsa.quantization_step(bits, rng)
    for n in (1, 2, 5, 16):
        assert secure_agg.default_threshold(n) == jsa.default_threshold(n)


@pytest.mark.parametrize("dropped", [(), (3,), (0, 5)])
def test_protocol_payloads_and_finalize_are_bit_identical(dropped):
    advertised = [0, 2, 3, 5, 6, 9]
    dim = 97
    rng = np.random.default_rng(len(dropped))
    vecs = {c: rng.normal(scale=0.1, size=dim) for c in advertised}
    sar = secure_agg.SecureAggRound(3, 1, advertised, dim)
    jsar = jsa.SecureAggRound(3, 1, advertised, dim)
    survivors = [c for c in advertised if c not in dropped]
    for c in survivors:
        payload = sar.client_payload(c, vecs[c])
        np.testing.assert_array_equal(payload, jsar.client_payload(c, vecs[c]))
        sar.accumulate(c, payload)
        jsar.accumulate(c, payload)
    total, info = sar.finalize(survivors)
    jtotal, jinfo = jsar.finalize(survivors)
    np.testing.assert_array_equal(total, jtotal)
    assert info == jinfo and info["recovered_seeds"] == len(dropped)
    want = np.sum([vecs[c] for c in survivors], axis=0)
    assert np.abs(total - want).max() <= len(survivors) * secure_agg.quantization_step(32, 32.0)


def test_unrecoverable_dropout_raises_in_both_packages():
    advertised = list(range(6))
    for mod in (secure_agg, jsa):
        sar = mod.SecureAggRound(0, 0, advertised, 5, threshold=4)
        for c in (0, 1, 2):
            sar.accumulate(c, sar.client_payload(c, np.zeros(5)))
        with pytest.raises(mod.DropoutRecoveryError):
            sar.finalize([0, 1, 2])


def test_flatten_pytree_round_trips_the_ports_trees():
    tree = [{"W": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": torch.ones(3)},
            {"a": torch.tensor([0.5], dtype=torch.float64)}]
    vec, unflatten = flatten_pytree(tree)
    jvec, _ = jsa.flatten_pytree([{k: np.asarray(v) for k, v in l.items()} for l in tree])
    assert vec.dtype == np.float64 and vec.size == 10
    np.testing.assert_array_equal(vec, jvec)
    back = unflatten(vec)
    for layer, blayer in zip(tree, back):
        for k in layer:
            assert blayer[k].dtype == layer[k].dtype and torch.equal(blayer[k], layer[k])


# ---------------------------------------------------------------------------
# The pairwise masks and DP: the reference's properties
# ---------------------------------------------------------------------------

def _client_params(K, seed=1):
    rng = np.random.default_rng(seed)
    return [[{"W": torch.tensor(rng.normal(size=(3, 4)), dtype=torch.float32),
              "a": torch.tensor(rng.normal(size=4), dtype=torch.float32)}] for _ in range(K)]


def test_pairwise_masks_cancel_across_a_cohort_boundary():
    K = 6
    base = mask_base_key(0)
    sel = np.ones(K, np.float32)
    params = _client_params(K)
    masked = [add_client_mask(base, 0, c, sel, params[c], 1.0) for c in range(K)]
    plain = [sum(p[0][k] for p in params) for k in ("W", "a")]
    state = agg.running_init(params[0])
    for chunk in (masked[:3], masked[3:]):
        stacked = [{k: torch.stack([m[0][k] for m in chunk]) for k in ("W", "a")}]
        state = agg.running_update(state, stacked, np.ones(len(chunk), np.float32))
    for k, want in zip(("W", "a"), plain):
        np.testing.assert_allclose(state.sum[0][k].numpy(), want.numpy(), atol=MASK_ATOL)
    assert float(masked[0][0]["W"].sub(params[0][0]["W"]).abs().max()) > 0.1


def test_pairwise_masks_skip_unselected_clients_and_depend_on_the_round():
    K = 5
    base = mask_base_key(3)
    sel = np.array([1, 0, 1, 1, 0], np.float32)
    template = _client_params(1)[0]
    off = client_mask(base, 2, 1, sel, template, 1.0)
    assert all(float(v.abs().max()) == 0.0 for v in off[0].values())
    total = [client_mask(base, 2, c, sel, template, 1.0) for c in (0, 2, 3)]
    np.testing.assert_allclose(sum(m[0]["W"] for m in total).numpy(), 0.0, atol=MASK_ATOL)
    again = client_mask(base, 2, 0, sel, template, 1.0)
    other = client_mask(base, 3, 0, sel, template, 1.0)
    assert torch.equal(again[0]["W"], total[0][0]["W"])
    assert not torch.allclose(other[0]["W"], total[0][0]["W"])
    assert secure_agg.pair_key(base, 2, 0, 3) == secure_agg.pair_key(base, 2, 3, 0)


def test_stream_keys_are_distinct_and_deterministic():
    keys = [noise_base_key(0), mask_base_key(0), pack_noise_key(0), noise_base_key(1)]
    assert len(set(keys)) == 4 and noise_base_key(0) == noise_base_key(0)
    assert client_round_key(keys[0], 1, 2) != client_round_key(keys[0], 2, 1)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    tree = [{"W": rng.normal(size=(4, 3)).astype(np.float32),
             "a": rng.normal(size=5).astype(np.float32)}]
    for max_norm in (0.1, 1.0, 100.0):
        got = clip_by_global_norm([{k: torch.from_numpy(v) for k, v in tree[0].items()}],
                                  max_norm)
        want = j_clip_by_global_norm([{k: jnp.asarray(v) for k, v in tree[0].items()}],
                                     max_norm)
        for k in tree[0]:
            np.testing.assert_allclose(got[0][k].numpy(), np.asarray(want[0][k]),
                                       rtol=1e-6, atol=1e-7)


def test_dp_transform_clips_and_adds_calibrated_noise():
    priv = PrivacyConfig(noise_multiplier=0.8, clip=0.5)
    jpriv = JPrivacyConfig(noise_multiplier=0.8, clip=0.5)
    assert per_client_noise_std(priv, 4) == pytest.approx(0.8 * 0.5 / 2)
    from repro.privacy import per_client_noise_std as j_std
    assert per_client_noise_std(priv, 4) == j_std(jpriv, 4)
    g = [{"W": torch.zeros(200, 50)}]
    local = [{"W": torch.full((200, 50), 0.3)}]
    clip_only = make_dp_transform(PrivacyConfig(clip=0.5), 4)(11, g, local)
    norm = float(torch.linalg.vector_norm(clip_only[0]["W"]))
    assert norm == pytest.approx(0.5, rel=1e-5)
    dp = make_dp_transform(priv, 4)
    a, b, c = dp(11, g, local), dp(11, g, local), dp(12, g, local)
    assert torch.equal(a[0]["W"], b[0]["W"]) and not torch.equal(a[0]["W"], c[0]["W"])
    noise = (a[0]["W"] - clip_only[0]["W"]).double()
    assert float(noise.std()) == pytest.approx(0.2, rel=0.03)
    assert abs(float(noise.mean())) < 0.01
    noised = tree_add_normal(5, [{"x": torch.zeros(10_000), "y": torch.zeros(10_000)}], 1.0)
    assert not torch.equal(noised[0]["x"], noised[0]["y"])


# ---------------------------------------------------------------------------
# Pack noise: the sensitivities exactly, the noise statistically
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["matrix", "vector"])
@pytest.mark.parametrize("granularity,influence", [("edge", 1), ("node", 7)])
def test_pack_sensitivities_equal_the_reference_on_its_own_packs(tiny, engine, granularity,
                                                                 influence):
    g, jg = tiny
    jpack = JFedGAT(JFedGATConfig(engine=engine, degree=10)).precommunicate(
        jax.random.PRNGKey(0), jg)
    pack = pack_from_numpy(jpack, device=CPU)
    got = pack_sensitivities(pack, g.features, granularity=granularity,
                             node_influence=influence)
    want = jpack_dp.pack_sensitivities(jpack, jnp.asarray(jg.features),
                                       granularity=granularity, node_influence=influence)
    assert got == want
    assert pack_dp.feature_norm_bound(torch.as_tensor(g.features)) == \
        jpack_dp.feature_norm_bound(jg.features)
    assert pack_dp.node_influence_bound(g) == jpack_dp.node_influence_bound(jg)
    assert pack_dp.projector_norm(1.7) == jpack_dp.projector_norm(1.7)
    assert pack_dp.pack_release_steps() == jpack_dp.pack_release_steps()


@pytest.mark.parametrize("name", ["tiny", "sbm_1k", "sbm_10k"])
def test_feature_norm_bound_is_exact(name):
    from repro.graphs import make_sbm as j_make_sbm
    from repro_torch.graphs import make_sbm

    g = make_cora_like("tiny", 0) if name == "tiny" else make_sbm(name, 0)
    jg = j_make_cora_like("tiny", 0) if name == "tiny" else j_make_sbm(name, 0)
    assert pack_dp.feature_norm_bound(g.features) == jpack_dp.feature_norm_bound(jg.features)


@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_noisy_pack_has_the_calibrated_std_and_keeps_exact_fields(tiny, engine):
    g, jg = tiny
    jpack = JFedGAT(JFedGATConfig(engine=engine, degree=10)).precommunicate(
        jax.random.PRNGKey(0), jg)
    pack = pack_from_numpy(jpack, device=CPU)
    sens = pack_sensitivities(pack, g.features)
    noised = noisy_pack(pack_noise_key(0), pack, g.features, 0.5)
    assert type(noised) is type(pack)
    assert noisy_pack(pack_noise_key(0), pack, g.features, 0.0) is pack
    again = noisy_pack(pack_noise_key(0), pack, g.features, 0.5)
    for name in pack._fields:
        clean, got = getattr(pack, name), getattr(noised, name)
        if name not in sens:
            assert got is clean or torch.equal(got, clean)
            continue
        assert torch.equal(got, getattr(again, name))
        diff = (got - clean).double()
        assert float(diff.std()) == pytest.approx(0.5 * sens[name], rel=0.1), name
    with pytest.raises(ValueError):
        noisy_pack(0, pack, g.features, -1.0)


# ---------------------------------------------------------------------------
# privacy_report and the refusals
# ---------------------------------------------------------------------------

REPORT_CASES = [
    dict(),
    dict(clip=1.0),
    dict(clip=1.0, noise_multiplier=0.7),
    dict(clip=1.0, noise_multiplier=0.7, secure_agg=True),
    dict(secure_agg=True, secure_agg_mode="pairwise"),
    dict(pack_noise_multiplier=0.5),
    dict(pack_noise_multiplier=0.5, clip=2.0, noise_multiplier=1.1, dp_granularity="node"),
]


@pytest.mark.parametrize("priv", REPORT_CASES)
@pytest.mark.parametrize("released", [True, False])
def test_privacy_report_matches_field_by_field(priv, released):
    influence = 9 if priv.get("dp_granularity") == "node" else None
    kw = dict(rounds=20, num_clients=8, num_selected=3, pack_released=released,
              node_influence=influence)
    got = privacy_report(PrivacyConfig(**priv), **kw)
    want = j_privacy_report(JPrivacyConfig(**priv), **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k


REFUSED = [
    dict(aggregation_mode="buffered", churn_drop_rate=0.1,
         priv=dict(noise_multiplier=1.0, clip=1.0)),
    dict(aggregation_mode="buffered", churn_join_rate=0.1, priv=dict(secure_agg=True)),
    dict(priv=dict(pack_noise_multiplier=0.5)),
    dict(method="fedgcn", priv=dict(pack_noise_multiplier=0.5)),
    dict(max_concurrent_clients=0),
    dict(max_concurrent_clients=5),
    dict(churn_drop_rate=0.2),
    dict(priv=dict(noise_multiplier=1.0)),
    dict(priv=dict(secure_agg=True, quant_bits=4)),
]


@pytest.mark.parametrize("kw", REFUSED)
def test_refused_configs_raise_what_the_reference_raises(kw):
    kw = dict(kw)
    cfg, jcfg = _configs(kw.pop("priv", None), num_clients=4, **kw)
    with pytest.raises(ValueError) as err:
        jtrainer.Trainer(jcfg)
    with pytest.raises(ValueError) as got:
        Trainer(cfg, device=CPU)
    assert str(got.value) == str(err.value)


# ---------------------------------------------------------------------------
# Through the Trainer
# ---------------------------------------------------------------------------

def test_clip_only_dp_matches_the_reference(tiny):
    g, jg = tiny
    cfg, jcfg = _configs(dict(clip=0.05), num_clients=4, rounds=3, local_steps=2,
                         client_fraction=0.5)
    params, _ = _reference_start(jcfg, jg)
    res = run_federated(g, cfg, device=CPU, params=params)
    jres = jtrainer.run_federated(jg, jcfg)
    np.testing.assert_allclose(res["val_curve"], jres["val_curve"], atol=CURVE_ATOL)
    np.testing.assert_allclose(res["test_curve"], jres["test_curve"], atol=CURVE_ATOL)
    _assert_params_close(res["params"], jres["params"])
    assert res["privacy"] == jres["privacy"] and res["epsilon"] == math.inf
    free = run_federated(g, dataclasses.replace(cfg, privacy=PrivacyConfig()),
                         device=CPU, params=params)
    assert _param_diff(free["params"], res["params"]) > 1e-4


def test_dp_noise_runs_are_deterministic_and_accounted(tiny):
    g, _ = tiny
    cfg, jcfg = _configs(dict(clip=1.0, noise_multiplier=0.5), num_clients=6, rounds=2,
                         local_steps=2, client_fraction=0.5)
    telemetry.enable()
    try:
        a = run_federated(g, cfg, device=CPU)
        events = [e for e in telemetry.events() if e["event"] == "privacy.round"]
        gauge = telemetry.gauge("privacy.epsilon").value
    finally:
        telemetry.disable()
        telemetry.reset()
    b = run_federated(g, cfg, device=CPU)
    assert a["val_curve"] == b["val_curve"] and _param_diff(a["params"], b["params"]) == 0.0
    want = jacc.compute_epsilon(0.5, 2, 3 / 6, 1e-5)
    assert a["epsilon"] == want == jtrainer.privacy_report(
        jcfg.privacy, rounds=2, num_clients=6, num_selected=3)["epsilon"]
    assert [e["round"] for e in events][-2:] == [0, 1] and gauge == want
    cohort = run_federated(g, dataclasses.replace(cfg, max_concurrent_clients=2),
                           device=CPU)
    np.testing.assert_allclose(cohort["val_curve"], a["val_curve"], atol=CURVE_ATOL)
    assert _param_diff(cohort["params"], a["params"]) < 1e-5
    free = run_federated(g, dataclasses.replace(cfg, privacy=PrivacyConfig()),
                         device=CPU)
    assert _param_diff(free["params"], a["params"]) > 1e-3


@pytest.mark.parametrize("mode,lanes", [("pairwise", None), ("pairwise", 2), ("protocol", None),
                                        ("protocol", 2)])
@pytest.mark.parametrize("frac", [1.0, 0.5])
def test_secure_aggregation_round_equals_the_unmasked_round(tiny, mode, lanes, frac):
    g, _ = tiny
    cfg, _ = _configs(num_clients=6, rounds=1, local_steps=2, client_fraction=frac,
                      max_concurrent_clients=lanes)
    r0 = run_federated(g, cfg, device=CPU)
    rs = run_federated(g, dataclasses.replace(cfg, privacy=PrivacyConfig(
        secure_agg=True, secure_agg_mode=mode)), device=CPU)
    assert _param_diff(r0["params"], rs["params"]) < EXACT_ROUND
    assert rs["privacy"]["secure_agg_mode"] == mode
    assert (rs["cohort"] is None) == (mode == "pairwise" and lanes is None)


def test_protocol_with_dropouts_matches_the_reference_and_recovers(tiny):
    g, jg = tiny
    cfg, jcfg = _configs(dict(secure_agg=True), num_clients=8, rounds=4, local_steps=2,
                         aggregation_mode="buffered", max_concurrent_clients=4,
                         churn_drop_rate=0.12, seed=1)
    params, _ = _reference_start(jcfg, jg)
    before = telemetry.counter("privacy.secure_agg.recovered_seeds").value
    res = run_federated(g, cfg, device=CPU, params=params)
    assert telemetry.counter("privacy.secure_agg.recovered_seeds").value > before
    jres = jtrainer.run_federated(jg, jcfg)
    np.testing.assert_allclose(res["val_curve"], jres["val_curve"], atol=CURVE_ATOL)
    _assert_params_close(res["params"], jres["params"])
    assert res["cohort"] == jres["cohort"]
    free = run_federated(g, dataclasses.replace(cfg, privacy=PrivacyConfig()),
                         device=CPU, params=params)
    assert free["val_curve"] == res["val_curve"]


def test_unrecoverable_round_degrades_and_counts(tiny):
    g, _ = tiny
    cfg, _ = _configs(dict(secure_agg=True), num_clients=8, rounds=3, local_steps=2,
                      aggregation_mode="buffered", max_concurrent_clients=4,
                      churn_drop_rate=0.4)
    before = telemetry.counter("privacy.secure_agg.recovery_failures").value
    rs = run_federated(g, cfg, device=CPU)
    assert telemetry.counter("privacy.secure_agg.recovery_failures").value > before
    r0 = run_federated(g, dataclasses.replace(cfg, privacy=PrivacyConfig()),
                       device=CPU)
    assert r0["val_curve"] == rs["val_curve"]


@pytest.mark.parametrize("engine,gran", [("matrix", "client"), ("vector", "node")])
def test_pack_noise_runs_and_reports_the_references_pack_epsilon(tiny, engine, gran):
    """At the reference's own multiplier (tests/test_privacy.py:403): at
    0.5 its matrix and vector runs on ``tiny`` diverge to non-finite
    params, as the port's do."""
    g, jg = tiny
    priv = dict(pack_noise_multiplier=0.05, dp_granularity=gran)
    cfg, jcfg = _configs(priv, num_clients=4, rounds=2, local_steps=1,
                         model=dict(engine=engine, degree=10))
    res = run_federated(g, cfg, device=CPU)
    assert all(np.isfinite(res["val_curve"]))
    assert all(bool(torch.isfinite(p).all()) for p in res["params"].parameters())
    want = j_privacy_report(jcfg.privacy, rounds=2, num_clients=4, num_selected=4,
                            pack_released=True,
                            node_influence=jpack_dp.node_influence_bound(jg)
                            if gran == "node" else None)
    assert res["privacy"] == want and res["privacy"]["pack_epsilon"] > 0


# ---------------------------------------------------------------------------
# The membership-inference audit
# ---------------------------------------------------------------------------

def test_mia_scores_and_attacks_match_reference():
    rng = np.random.default_rng(4)
    logits = (2 * rng.standard_normal((60, 5))).astype(np.float32)
    labels = rng.integers(0, 5, 60)
    got = mia.node_scores(torch.from_numpy(logits), labels)
    want = jmia.node_scores(jnp.asarray(logits), labels)
    for k in ("loss", "confidence"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7)
        assert got[k].dtype == np.float64
    scores = want["loss"]
    scores[::7] = scores[1]                       # ties
    member, nonmember = scores[:25], scores[25:]
    for a, b in zip(mia.attack_curve(-member, -nonmember),
                    jmia.attack_curve(-member, -nonmember)):
        np.testing.assert_array_equal(a, b)
    assert mia._auc(member, nonmember) == jmia._auc(member, nonmember)
    for score in mia.SCORES:
        out = mia.threshold_attack(member, nonmember, score)
        assert out == jmia.threshold_attack(member, nonmember, score)
        assert mia.calibrated_attack(member, nonmember, out["threshold"], score) == \
            jmia.calibrated_attack(member, nonmember, out["threshold"], score)
    with pytest.raises(ValueError):
        mia.threshold_attack(member, nonmember, "entropy")


def test_membership_inference_harness_runs_through_the_trainer(tiny):
    g, jg = tiny
    cfg, jcfg = _configs(dict(clip=1.0, noise_multiplier=0.3), num_clients=4, rounds=2,
                         local_steps=2)
    out = mia.run_membership_inference(g, cfg, device=CPU)
    jout = jmia.run_membership_inference(jg, jcfg)
    assert set(out) == set(jout)
    assert 0.0 <= out["advantage"] <= 1.0 and out["privacy"] == jout["privacy"]
    assert (out["n_members"], out["n_nonmembers"]) == (jout["n_members"], jout["n_nonmembers"])
    assert out == mia.run_membership_inference(g, cfg, device=CPU)
    shadow = mia.shadow_attack(g, cfg, shadow_seeds=(1,), device=CPU)
    assert set(shadow) == set(jmia.shadow_attack(jg, jcfg, shadow_seeds=(1,)))
    with pytest.raises(ValueError):
        mia.shadow_attack(g, cfg, shadow_seeds=(0,), device=CPU)
