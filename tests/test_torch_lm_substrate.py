"""The port's LM substrate against the JAX package: the synthetic token
pipeline (bit for bit), the learning-rate schedules, ``sgd_update``, the
train step (one AdamW step, with and without gradient accumulation, for a
float32 and a bfloat16 ``reduced()`` config) and checkpoints of LM params
both ways, bf16 leaves included.

Tolerances: the float32 train step's loss and moments at rtol 1e-5, and
its params at rtol 1e-5 (and 1e-5 of the step lr) wherever the
reference's gradient |g| >= 1e-6.
Adam's first update is lr * g / (|g| + eps) with eps 1e-8: below 100 eps
it turns the gradients' own rounding difference (rtol 1e-3 in
test_torch_lm_models.py) into a step of up to lr, so there a param is held
to 2 lr (a flipped sign at most). bf16 steps: the dtypes equal, and
values within bf16 rounding (below).
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.configs import get_config as j_get_config
from repro.data import make_lm_batches as j_make_lm_batches
from repro.launch.steps import adam_init_f32 as j_adam_init_f32
from repro.launch.steps import make_decode_step as j_make_decode_step
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models import build_model as j_build_model
from repro.models import transformer as jtf
from repro.optim import constant_schedule as j_constant_schedule
from repro.optim import cosine_schedule as j_cosine_schedule
from repro.optim import sgd_update as j_sgd_update
from repro_torch._tree import tree_leaves
from repro_torch.checkpoint import load_checkpoint, save_checkpoint, unflatten
from repro_torch.configs import get_config
from repro_torch.data import make_lm_batches
from repro_torch.launch.steps import (
    adam_init_f32,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    value_and_grad,
)
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as tf
from repro_torch.optim import constant_schedule, cosine_schedule, sgd_update

torch.set_num_threads(1)

CPU = torch.device("cpu")
STEP_RTOL = 1e-5
LR, ADAM_EPS = 3e-4, 1e-8   # repro/launch/steps.py, repro/optim/adamw.py
BF16_EPS = 2.0 ** -8        # bfloat16 unit roundoff


def by_path(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(by_path(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    return {prefix: np.asarray(tree)}


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    a = np.asarray(x)
    return a.astype(np.float32)


def dtype_name(x):
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


# ---------------------------------------------------------------------------
# data pipeline, schedules, sgd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 11])
def test_make_lm_batches_bit_for_bit(seed):
    kw = dict(seed=seed, prefix=(4, 8), frames=(6, 8))
    mine, ref = make_lm_batches(100, 3, 16, **kw), j_make_lm_batches(100, 3, 16, **kw)
    for _ in range(3):
        a, b = next(mine), next(ref)
        assert sorted(a) == sorted(b) == ["frames", "labels", "prefix", "tokens"]
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_schedules_equal_the_references():
    steps = range(0, 131)
    cases = [(3e-4, constant_schedule(3e-4), j_constant_schedule(3e-4)),
             (1e-3, cosine_schedule(1e-3, 10, 100), j_cosine_schedule(1e-3, 10, 100)),
             (0.5, cosine_schedule(0.5, 0, 64, floor=0.0), j_cosine_schedule(0.5, 0, 64, floor=0.0))]
    for peak, mine, ref in cases:
        got = np.array([mine(s).item() for s in steps], np.float32)
        want = np.array([np.float32(ref(s)) for s in steps], np.float32)
        assert all(mine(s).dtype == torch.float32 for s in (0, 50))
        # float32 cos in XLA and in torch may differ by an ulp; near the
        # floor 1 + cos cancels, so the schedule is held to one float32 ulp
        # of its peak (the warmup steps, below, exactly)
        np.testing.assert_allclose(got, want, rtol=0, atol=peak * 2 ** -23)
    warm = cosine_schedule(1e-3, 10, 100)
    np.testing.assert_array_equal([warm(s).item() for s in range(10)],
                                  [np.float32(j_cosine_schedule(1e-3, 10, 100)(s))
                                   for s in range(10)])


def test_sgd_update():
    p = sgd_update({"w": torch.tensor(2.0)}, {"w": torch.tensor(1.0)}, lr=0.5)
    assert float(p["w"]) == 0.0
    rng = np.random.default_rng(0)
    g, w = rng.standard_normal((2, 5, 3)).astype(np.float32)
    got = sgd_update({"a": {"b": torch.from_numpy(g)}}, {"a": {"b": torch.from_numpy(w)}}, 0.1)
    want = j_sgd_update({"a": {"b": jnp.asarray(g)}}, {"a": {"b": jnp.asarray(w)}}, 0.1)
    np.testing.assert_array_equal(got["a"]["b"].numpy(), np.asarray(want["a"]["b"]))


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _step_inputs(name, dtype):
    jcfg = dataclasses.replace(j_get_config(name).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(name).reduced(), dtype=dtype)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    batch = next(make_lm_batches(cfg.vocab_size, 4, 16, seed=2))
    return jcfg, cfg, jparams, batch


def _both_steps(name, dtype, microbatches):
    jcfg, cfg, jparams, batch = _step_inputs(name, dtype)
    jopt = j_adam_init_f32(jparams)
    jstep = jax.jit(j_make_train_step(jcfg, microbatches=microbatches))
    jp, jo, jloss = jstep(jparams, jopt, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    opt = adam_init_f32(params)
    assert all(m.dtype == torch.float32 for m in tree_leaves(opt.mu) + tree_leaves(opt.nu))
    step = make_train_step(cfg, microbatches=microbatches)
    p, o, loss = step(params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    return (p, o, loss), (jp, jo, jloss)


def _dtypes_equal(got, want):
    g, w = by_path(got), by_path(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    assert {k: dtype_name(v) for k, v in g.items()} == {k: dtype_name(v) for k, v in w.items()}
    return g, w


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ["yi-6b", "granite-moe-1b-a400m"])
def test_train_step_matches_the_reference_float32(name, microbatches):
    (p, o, loss), (jp, jo, jloss) = _both_steps(name, "float32", microbatches)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_RTOL)
    assert int(o.step) == int(jo.step) == 1
    for got, want in ((o.mu, jo.mu), (o.nu, jo.nu)):
        g, w = _dtypes_equal(got, want)
        for k in w:
            np.testing.assert_allclose(as_f32(g[k]), as_f32(w[k]), rtol=STEP_RTOL,
                                       atol=STEP_RTOL * float(np.abs(as_f32(w[k])).max()),
                                       err_msg=k)
    g, w = _dtypes_equal(p, jp)
    grad = {k: 10 * np.abs(v) for k, v in by_path(jax.tree.map(np.asarray, jo.mu)).items()}
    for k in w:
        a, b = as_f32(g[k]), as_f32(w[k])
        firm = grad[k] >= 100 * ADAM_EPS           # mu = (1 - b1) g after one step
        np.testing.assert_allclose(a[firm], b[firm], rtol=STEP_RTOL, atol=STEP_RTOL * LR,
                                   err_msg=k)
        assert np.abs(a - b).max() <= 2 * LR, k


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_bf16_promotes_like_the_reference(microbatches):
    """A bf16 config: every param leaf comes back float32 (jnp and torch
    promote bf16 + float32 moments alike) and the moments are float32.
    bf16 activations differ by rounding, so the loss is held to a few bf16
    ulps, the first moments (0.1 g) to bf16 rounding of the gradients
    relative to the leaf's largest, and each param to 2 lr of its
    reference value (Adam's first step moves it by lr * (g / |g| + wd p),
    and a gradient within rounding of 0 may flip its sign), widened by a
    few bf16 ulps since bf16 rounds (1 - b2) g g and (1 - b1) g apart."""
    (p, o, loss), (jp, jo, jloss) = _both_steps("granite-moe-1b-a400m", "bfloat16", microbatches)
    assert all(t.dtype == torch.float32 for t in tree_leaves(p))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=8 * BF16_EPS)
    g, w = _dtypes_equal(p, jp)
    for k in w:
        np.testing.assert_allclose(as_f32(g[k]), as_f32(w[k]), rtol=0,
                                   atol=2 * LR * (1 + 4 * BF16_EPS), err_msg=k)
    g, w = _dtypes_equal(o.mu, jo.mu)
    for k in w:
        scale = float(np.abs(as_f32(w[k])).max())
        np.testing.assert_allclose(as_f32(g[k]), as_f32(w[k]), rtol=0,
                                   atol=32 * BF16_EPS * scale + 1e-12, err_msg=k)
    _dtypes_equal(o.nu, jo.nu)


def test_prefill_and_decode_step_builders_match_the_references():
    jcfg = j_get_config("chatglm3-6b").reduced()
    cfg = get_config("chatglm3-6b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(4))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jlg, jcache = j_make_prefill_step(jcfg, 24)(jparams, {"tokens": jnp.asarray(tok[:, :9])})
    lg, cache = make_prefill_step(cfg, 24)(params, {"tokens": torch.from_numpy(tok[:, :9])})
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-4, atol=1e-5)
    assert cache.kv.k.shape[2] == min(24, cfg.sliding_window) and not lg.requires_grad
    jlg, _ = j_make_decode_step(jcfg)(jparams, jcache, jnp.asarray(tok[:, 9:]))
    lg, cache = make_decode_step(cfg)(params, cache, torch.from_numpy(tok[:, 9:]))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), rtol=1e-4, atol=1e-5)
    assert int(cache.pos) == 10


def test_value_and_grad_gives_zeros_for_an_unreached_leaf():
    cfg = get_config("yi-6b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(0), device=CPU)
    params["unused"] = {"w": torch.ones(3)}
    batch = {k: torch.from_numpy(v) for k, v in
             next(make_lm_batches(cfg.vocab_size, 2, 8, seed=0)).items()}
    loss, parts, grads = value_and_grad(build_model(cfg).loss, params, batch)
    assert torch.equal(grads["unused"]["w"], torch.zeros(3))
    assert sorted(parts) == ["ce", "moe_aux"] and loss.requires_grad is False


# ---------------------------------------------------------------------------
# checkpoints of LM params
# ---------------------------------------------------------------------------

def test_reference_checkpoint_loads_into_the_port(tmp_path):
    """The reference's ``save_checkpoint({"params": ...})`` read by the
    port's loader gives logits equal to the reference's own."""
    jcfg = j_get_config("hymba-1.5b").reduced()
    cfg = get_config("hymba-1.5b").reduced()
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(3))
    j_save_checkpoint(str(tmp_path / "ref.npz"), {"params": jparams}, step=7)
    flat, step = load_checkpoint(str(tmp_path / "ref.npz"))
    assert step == 7
    params = params_from_numpy(unflatten(flat)["params"], device=CPU)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = np.asarray(jtf.lm_forward(jparams, jcfg, jnp.asarray(tok))[0])
    with torch.no_grad():
        got = tf.lm_forward(params, cfg, torch.from_numpy(tok))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_port_checkpoint_loads_into_the_reference(tmp_path):
    """``train lm``'s checkpoint layout: the port's ``{"params": ...}``
    restored by the reference's loader into its own template."""
    jcfg = j_get_config("rwkv6-1.6b").reduced()
    cfg = get_config("rwkv6-1.6b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(1), device=CPU)
    save_checkpoint(str(tmp_path / "port.npz"), {"params": params}, step=2)
    template = {"params": j_build_model(jcfg).init(jax.random.PRNGKey(0))}
    restored, step = j_load_checkpoint(str(tmp_path / "port.npz"), template)
    assert step == 2
    got = by_path(jax.tree.map(np.asarray, restored["params"]))
    mine = by_path(params)
    assert sorted(got) == sorted(mine)
    for k in mine:
        np.testing.assert_array_equal(got[k], mine[k].numpy(), err_msg=k)


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bf16 bits: the port writes ``|V2`` that ``np.load`` reads with the
    same bits as the reference's own file of the same values, and a
    reference bf16 checkpoint loads into the port as torch.bfloat16."""
    jcfg = dataclasses.replace(j_get_config("yi-6b").reduced(), dtype="bfloat16")
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    j_save_checkpoint(str(tmp_path / "ref.npz"), {"params": jparams})
    flat, _ = load_checkpoint(str(tmp_path / "ref.npz"))
    params = params_from_numpy(unflatten(flat)["params"], device=CPU)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(params))
    save_checkpoint(str(tmp_path / "port.npz"), {"params": params})
    with np.load(tmp_path / "ref.npz") as ref, np.load(tmp_path / "port.npz") as port:
        assert sorted(ref.files) == sorted(port.files)
        for k in ref.files:
            assert ref[k].dtype == port[k].dtype
            assert port[k].tobytes() == ref[k].tobytes(), k
    want = by_path(jax.tree.map(np.asarray, jparams))
    for k, t in by_path(params).items():
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), want[k].view(np.int16))
    assert pathlib.Path(tmp_path / "port.npz").stat().st_size > 0
