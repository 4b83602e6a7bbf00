"""The port's language-model zoo (``repro_torch.models``) against the JAX
package's, for every assigned architecture's ``reduced()`` config: the
reference's own ``init`` params carried across with ``params_from_numpy``,
the same numpy-seeded tokens, prefix and frames, and the forward logits,
prefill logits and every cache leaf, one decode step, the loss with its
parts, and every gradient leaf compared.

Tolerances: values rtol 1e-4 / atol 1e-5 (float32; summation order and
transcendental rounding differ), gradients rtol 1e-3 / atol 1e-5 (the
reference's own gradient tolerance, tests/test_kernel_engine.py:275-276).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import encdec as jed
from repro.models import transformer as jtf
from repro.models.moe import init_moe as j_init_moe
from repro.models.moe import moe_ffn as j_moe_ffn
from repro_torch._tree import tree_leaves, tree_unflatten
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf
from repro_torch.models.moe import moe_ffn, top_k

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
B, S, CACHE_LEN = 2, 16, 32


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy() if x.is_floating_point() else x.numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def by_path(obj, prefix=""):
    """{path: array} over dicts, (named) tuples and leaves; the reference's
    ``0`` and the port's ``None`` (a family's absent cache part) give nothing."""
    if obj is None:
        return {}
    if isinstance(obj, dict):
        items = obj.items()
    elif hasattr(obj, "_fields"):
        items = [(k, v) for k, v in zip(obj._fields, obj)
                 if not (k in ("kv", "ssm") and (isinstance(v, int) or getattr(v, "shape", 0) == ()))]
    elif isinstance(obj, (tuple, list)):
        items = enumerate(obj)
    else:
        return {prefix: to_np(obj)}
    out = {}
    for k, v in items:
        out.update(by_path(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def assert_trees_close(got, want, rtol, atol, what):
    g, w = by_path(got), by_path(want)
    assert sorted(g) == sorted(w), (what, sorted(set(g) ^ set(w)))
    for k in w:
        assert g[k].shape == w[k].shape, (what, k, g[k].shape, w[k].shape)
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def make_inputs(cfg, seed=0, seq=S):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, size=(B, seq)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, size=(B, seq)).astype(np.int32)
    lab[0, :3] = -100                                  # masked positions
    batch = {"tokens": tok, "labels": lab}
    if cfg.family == "vlm":
        batch["prefix"] = rng.standard_normal((B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, max(seq // cfg.encoder_ratio, 2), cfg.d_model)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def reference_run(jcfg, jparams, batch):
    """The reference's forward, prefill, decode step, loss and grads."""
    jm = j_build_model(jcfg)
    jb = jax_batch(batch)
    out = {}
    if jcfg.is_encdec:
        out["forward"] = jax.jit(lambda p, b: jed.decode_train(
            p, jcfg, b["tokens"], jed.encode(p, jcfg, b["frames"])))(jparams, jb)
    else:
        out["forward"] = jax.jit(lambda p, b: jtf.lm_forward(
            p, jcfg, b["tokens"], prefix=b.get("prefix"), coeffs=jtf.cheb_coeffs(jcfg))[0])(
                jparams, jb)
    pb = {k: v for k, v in jb.items() if k != "labels"}
    pb["tokens"] = jb["tokens"][:, : S - 1]
    out["prefill"] = jax.jit(lambda p, b: jm.prefill(p, dict(b, cache_len=CACHE_LEN)))(jparams, pb)
    out["decode"] = jax.jit(jm.decode_step)(jparams, out["prefill"][1], jb["tokens"][:, S - 1:])
    (loss, parts), grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jparams, jb)
    out["loss"] = (loss, parts)
    out["grads"] = grads
    return out


@pytest.fixture(scope="module", params=ASSIGNED_ARCHS)
def arch(request):
    """One reference init and run per arch; the port's params carried."""
    name = request.param
    jcfg = j_get_config(name).reduced()
    cfg = get_config(name).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    batch = make_inputs(cfg)
    ref = reference_run(jcfg, jparams, batch)
    host = jax.tree.map(np.asarray, jparams)
    params = params_from_numpy(host, device=CPU)
    return {"name": name, "cfg": cfg, "params": params, "batch": batch, "ref": ref,
            "model": build_model(cfg), "host": host}


def test_archs_match_the_reference_registry():
    assert ASSIGNED_ARCHS == J_ARCHS


def test_params_carry_keeps_paths_shapes_and_dtypes(arch):
    want = by_path(arch["host"])
    got = by_path(arch["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(p.dtype == torch.float32 for p in tree_leaves(arch["params"]))


def test_forward_logits(arch):
    cfg, p, b = arch["cfg"], arch["params"], torch_batch(arch["batch"])
    with torch.no_grad():
        if cfg.is_encdec:
            memory = ed.encode(p, cfg, b["frames"])
            got = ed.decode_train(p, cfg, b["tokens"], memory)
        else:
            got = tf.lm_forward(p, cfg, b["tokens"], prefix=b.get("prefix"),
                                coeffs=tf.cheb_coeffs(cfg))[0]
    np.testing.assert_allclose(to_np(got), to_np(arch["ref"]["forward"]), rtol=RTOL, atol=ATOL)


def _prefill(arch):
    b = torch_batch(arch["batch"])
    pb = {k: v for k, v in b.items() if k != "labels"}
    pb["tokens"] = b["tokens"][:, : S - 1]
    pb["cache_len"] = CACHE_LEN
    with torch.no_grad():
        return arch["model"].prefill(arch["params"], pb)


def test_prefill_logits_and_cache(arch):
    logits, cache = _prefill(arch)
    want_logits, want_cache = arch["ref"]["prefill"]
    np.testing.assert_allclose(to_np(logits), to_np(want_logits), rtol=RTOL, atol=ATOL)
    assert_trees_close(cache, want_cache, RTOL, ATOL, "prefill cache")


def test_decode_step(arch):
    _, cache = _prefill(arch)
    tok = torch.from_numpy(arch["batch"]["tokens"][:, S - 1:])
    with torch.no_grad():
        logits, cache = arch["model"].decode_step(arch["params"], cache, tok)
    want_logits, want_cache = arch["ref"]["decode"]
    np.testing.assert_allclose(to_np(logits), to_np(want_logits), rtol=RTOL, atol=ATOL)
    assert_trees_close(cache, want_cache, RTOL, ATOL, "decode cache")


def _loss_and_grads(arch):
    leaves = [t.detach().clone().requires_grad_() for t in tree_leaves(arch["params"])]
    params = tree_unflatten(arch["params"], leaves)
    loss, parts = arch["model"].loss(params, torch_batch(arch["batch"]))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
    return loss, parts, tree_unflatten(arch["params"], grads)


def test_loss_and_parts(arch):
    loss, parts, _ = _loss_and_grads(arch)
    want_loss, want_parts = arch["ref"]["loss"]
    np.testing.assert_allclose(to_np(loss), to_np(want_loss), rtol=RTOL, atol=ATOL)
    assert sorted(parts) == sorted(want_parts)
    for k in want_parts:
        np.testing.assert_allclose(to_np(parts[k]), to_np(want_parts[k]), rtol=RTOL, atol=ATOL)


def test_every_grad_leaf(arch):
    _, _, grads = _loss_and_grads(arch)
    assert_trees_close(grads, arch["ref"]["grads"], GRAD_RTOL, GRAD_ATOL, "grads")


# ---------------------------------------------------------------------------
# Variants: chebyshev attention, the circular cache past W, MoE routing
# ---------------------------------------------------------------------------

def _carried(jcfg, seed=0):
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(seed))
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)


def test_chebyshev_variant_forward_decode_loss_and_grads():
    jcfg = dataclasses.replace(j_get_config("yi-6b").reduced(),
                               attention_variant="chebyshev", cheb_degree=8)
    cfg = dataclasses.replace(get_config("yi-6b").reduced(),
                              attention_variant="chebyshev", cheb_degree=8)
    jparams, params = _carried(jcfg)
    np.testing.assert_allclose(tf.cheb_coeffs(cfg), np.asarray(jtf.cheb_coeffs(jcfg)), rtol=1e-6)
    batch = make_inputs(cfg, seed=3)
    ref = reference_run(jcfg, jparams, batch)
    a = {"cfg": cfg, "params": params, "batch": batch, "ref": ref, "model": build_model(cfg)}
    test_forward_logits(a)
    test_prefill_logits_and_cache(a)
    test_decode_step(a)
    test_loss_and_parts(a)
    test_every_grad_leaf(a)


def test_sliding_window_circular_cache_past_the_window():
    """``test_archs.py:124``'s config: decode W + 9 tokens from an empty
    cache of W slots, every step's logits and the final cache against the
    reference's; then a prefill longer than W (the roll) and one step."""
    jcfg = j_get_config("yi-6b").reduced()
    cfg = get_config("yi-6b").reduced()
    W = cfg.sliding_window
    assert W == 16
    jparams, params = _carried(jcfg)
    jm, m = j_build_model(jcfg), build_model(cfg)
    seq = W + 9
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(B, seq)).astype(np.int32)
    jcache, cache = jm.init_cache(B, W), m.init_cache(B, W, device=CPU)
    jdecode = jax.jit(jm.decode_step)
    with torch.no_grad():
        for t in range(seq):
            jlg, jcache = jdecode(jparams, jcache, jnp.asarray(tok[:, t:t + 1]))
            lg, cache = m.decode_step(params, cache, torch.from_numpy(tok[:, t:t + 1]))
            np.testing.assert_allclose(to_np(lg), to_np(jlg), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t}")
        assert_trees_close(cache, jcache, RTOL, ATOL, "cache after W + 9 steps")
        # prefill of W + 4 tokens keeps the last W, rolled to slots p % W
        n = W + 4
        jlg, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(tok[:, :n]), "cache_len": 64})
        lg, cache = m.prefill(params, {"tokens": torch.from_numpy(tok[:, :n]), "cache_len": 64})
        np.testing.assert_allclose(to_np(lg), to_np(jlg), rtol=RTOL, atol=ATOL)
        assert_trees_close(cache, jcache, RTOL, ATOL, "rolled prefill cache")
        assert cache.kv.k.shape[2] == W
        jlg, jcache = jdecode(jparams, jcache, jnp.asarray(tok[:, n:n + 1]))
        lg, cache = m.decode_step(params, cache, torch.from_numpy(tok[:, n:n + 1]))
        np.testing.assert_allclose(to_np(lg), to_np(jlg), rtol=RTOL, atol=ATOL)
        assert_trees_close(cache, jcache, RTOL, ATOL, "cache after the rolled prefill")


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "dbrx-132b"])
def test_moe_routing_selects_the_references_experts(name):
    jcfg = j_get_config(name).reduced()
    cfg = get_config(name).reduced()
    jp = j_init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    x = np.random.default_rng(7).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    k = cfg.experts_per_token
    jprobs = jax.nn.softmax(jnp.asarray(x).reshape(-1, cfg.d_model) @ jp["router"]["w"], axis=-1)
    want_sel = np.asarray(jax.lax.top_k(jprobs, k)[1])
    with torch.no_grad():
        xt = torch.from_numpy(x)
        probs = torch.softmax(xt.reshape(-1, cfg.d_model) @ p["router"]["w"], dim=-1)
        sel = top_k(probs, k)[1].numpy()
        out, aux = moe_ffn(p, cfg, xt)
    srt = np.sort(np.asarray(jprobs), axis=-1)[:, ::-1]
    gap = float((srt[:, k - 1] - srt[:, k]).min())
    print(f"{name}: smallest gap between the k-th and (k+1)-th router prob {gap:.3e}")
    np.testing.assert_array_equal(sel, want_sel)
    jout, jaux = j_moe_ffn(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    for key in ("moe_aux_loss", "moe_drop_frac"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=RTOL, atol=ATOL)


def test_moe_zero_router_ties_break_like_jax_top_k():
    """Uniform router probs: ``jax.lax.top_k`` takes the lowest indices."""
    jcfg = j_get_config("granite-moe-1b-a400m").reduced()
    cfg = get_config("granite-moe-1b-a400m").reduced()
    jp = j_init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    jp["router"]["w"] = jnp.zeros_like(jp["router"]["w"])
    p = params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    x = np.random.default_rng(1).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    probs = torch.full((32, cfg.num_experts), 1.0 / cfg.num_experts)
    assert top_k(probs, 2)[1].tolist() == [[0, 1]] * 32
    with torch.no_grad():
        out, aux = moe_ffn(p, cfg, torch.from_numpy(x))
    jout, jaux = j_moe_ffn(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    assert float(aux["moe_aux_loss"]) == pytest.approx(float(jaux["moe_aux_loss"]), rel=1e-6)


def test_bf16_params_carry_and_run():
    """A bfloat16 tree (the full configs' dtype) carried bit for bit; its
    forward is finite and as far from the float32 forward as the
    reference's bf16 forward is (within twice its error)."""
    jcfg = dataclasses.replace(j_get_config("granite-moe-1b-a400m").reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), dtype="bfloat16")
    jparams, params = _carried(jcfg)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(params))
    want = by_path(jax.tree.map(np.asarray, jparams))
    got = by_path(params)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    tok = make_inputs(cfg)["tokens"]
    f32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    exact = np.asarray(jtf.lm_forward(f32, dataclasses.replace(jcfg, dtype="float32"),
                                      jnp.asarray(tok))[0])
    ref_err = np.abs(np.asarray(jtf.lm_forward(jparams, jcfg, jnp.asarray(tok))[0]) - exact).max()
    with torch.no_grad():
        logits = tf.lm_forward(params, cfg, torch.from_numpy(tok))[0]
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    err = np.abs(logits.numpy() - exact).max()
    print(f"bf16 forward vs float32: port {err:.3e}, reference {ref_err:.3e}")
    assert err <= 2 * ref_err


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "hymba-1.5b"])
def test_decode_from_an_empty_cache(name):
    """``init_cache`` then token-by-token decode (the RWKV and Mamba states
    from zeros), every step's logits and the final cache against the
    reference's."""
    jcfg, cfg = j_get_config(name).reduced(), get_config(name).reduced()
    jparams, params = _carried(jcfg, seed=2)
    jm, m = j_build_model(jcfg), build_model(cfg)
    tok = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(B, 6)).astype(np.int32)
    jcache, cache = jm.init_cache(B, 8), m.init_cache(B, 8, device=CPU)
    assert_trees_close(cache, jcache, 0, 0, "empty cache")
    jdecode = jax.jit(jm.decode_step)
    with torch.no_grad():
        for t in range(tok.shape[1]):
            jlg, jcache = jdecode(jparams, jcache, jnp.asarray(tok[:, t:t + 1]))
            lg, cache = m.decode_step(params, cache, torch.from_numpy(tok[:, t:t + 1]))
            np.testing.assert_allclose(to_np(lg), to_np(jlg), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {t}")
    assert_trees_close(cache, jcache, RTOL, ATOL, "cache after 6 steps")
