"""The port's mesh layer on gloo CPU ranks: ``moe_ffn_sharded`` and
``build_sharded_step`` against the port's single-device functions, and the
expert-parallel MoE's forward and grads against the JAX package's
``moe_ffn_sharded`` on 4 forced host devices, on the same numpy-seeded
inputs.

Two gangs, each started once through ``launch.multiprocess.launch`` and
bounded by ``SPAWN_TIMEOUT``: four ranks on a (2, 2) mesh (``reduced()``
configs, whose capacity factor is E, so no token drops), and two ranks on a
(1, 2) mesh with granite's own capacity factor (1.25: tokens drop, alike on
one data shard and on one device). Each rank computes its blocks; rank 0
gathers them and holds them against the single-device result:

* ``moe_ffn_sharded`` (each data shard routes its own rows; the aux loss is
  the mean over data shards): the output and the grads of x, the router
  and the experts of sum(out^2) against ``moe_ffn_dense`` on the whole
  batch, rtol 1e-5 / atol 1e-6 (values) and rtol 1e-3 (the LM grads' of
  tests/test_torch_lm_models.py) / atol 1e-5 of the leaf's largest |g|
  (grads, summed over ranks in another order: a router grad near 0 is a
  sum of terms of ~60). Neither grad is scaled by the
  model axis. The output, the aux loss and the grads of sum(out^2) + aux
  against the reference's sharded MoE at the same tolerances.
* ``build_sharded_step`` for reduced yi-6b, granite-moe-1b-a400m and
  rwkv6-1.6b under megatron, zero1, fsdp and megatron with 2 microbatches,
  and, on both meshes, the megatron train and decode steps of one reduced
  arch of each family those do not cover: chatglm3-6b (GQA, QKV bias),
  paligemma-3b (a VLM prefix, one KV head: on (1, 2) its ``wk``/``wv`` are
  gathered), hymba-1.5b (Mamba beside attention) and
  seamless-m4t-large-v2 (encoder-decoder), and reduced yi-6b with 9 query
  and 3 KV heads (``CUT_HEADS``: a model axis of 2 cuts inside a head, so
  ``wq``/``wk``/``wv`` are gathered and each rank computes the 5 heads its
  block of ``wo`` touches, grouped unevenly over their KV heads):
  the train step's loss, moments and gathered params against the
  single-device step at PR 20's rule (tests/test_torch_lm_substrate.py:
  loss and moments rtol 1e-5; params rtol 1e-5 where |g| >= 1e-6, else
  within 2 lr); the prefill's logits and cache and a decode step's logits
  and cache at rtol 1e-4 / atol 1e-5. The single-device step runs with as
  many microbatches as the sharded step splits the MoE's routing: the
  data shards times ``microbatches`` under megatron and zero1 (the
  reference routes, caps and averages the aux loss per data shard),
  ``microbatches`` under fsdp (its dense MoE spans the whole batch).
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro_torch.launch import multiprocess as mp

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SPAWN_TIMEOUT = 240                  # seconds a gang may take
ARCHS = ("yi-6b", "granite-moe-1b-a400m", "rwkv6-1.6b")
CUT_HEADS = "yi-6b:9x3"               # reduced yi-6b with 9 query and 3 KV heads of 64
FAMILIES = ("chatglm3-6b", "paligemma-3b", "hymba-1.5b", "seamless-m4t-large-v2", CUT_HEADS)
TRAIN = (("megatron", 1), ("zero1", 1), ("fsdp", 1), ("megatron", 2))
SERVE = ("megatron", "zero1", "fsdp")
GRANITE_FACTOR = 1.25                # configs/granite_moe_1b.py's capacity factor
MOE_SHAPE = (4, 8)                   # B, S of the MoE inputs


def _cases(mesh):
    families = [(a, k, "megatron", 1) for a in FAMILIES for k in ("train", "decode")]
    if mesh == (2, 2):
        steps = [(a, "train", s, m) for a in ARCHS for s, m in TRAIN]
        steps += [(a, k, s, 1) for a in ARCHS for k in ("prefill", "decode") for s in SERVE]
        return {"mesh": list(mesh), "factor": None, "steps": steps + families}
    steps = [("granite-moe-1b-a400m", k, "megatron", 1) for k in ("train", "prefill", "decode")]
    return {"mesh": list(mesh), "factor": GRANITE_FACTOR, "steps": steps + families}


def _case_id(case):
    arch, kind, strategy, mb = case
    return f"{arch}-{kind}-{strategy}" + (f"-mb{mb}" if mb > 1 else "")


WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch import multiprocess as mp
rank, nproc, _ = mp.initialize_worker(device="cpu")
import dataclasses
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import pspec
from repro_torch.launch.mesh import bind_mesh, make_debug_mesh
from repro_torch.launch.sharding import P, gather_tree, shard_tree
from repro_torch.launch.specs import cfg_for_shape
from repro_torch.launch.steps import (LR, adam_init_f32, build_sharded_step, make_decode_step,
                                      make_prefill_step, make_train_step)
from repro_torch.models import build_model
from repro_torch.models.moe import moe_ffn_dense, moe_ffn_sharded

out_dir, spec = sys.argv[1], json.loads(sys.argv[2])
B, S = 4, 16
bm = bind_mesh(make_debug_mesh(*spec["mesh"]))
D = bm.shape["data"]


def config(arch):
    arch, _, heads = arch.partition(":")     # "<arch>:<H>x<KV>" overrides the heads
    cfg = get_config(arch).reduced()
    if heads:
        H, KV = map(int, heads.split("x"))
        cfg = dataclasses.replace(cfg, num_heads=H, num_kv_heads=KV, head_dim=cfg.head_dim)
    return dataclasses.replace(cfg, moe_capacity_factor=spec["factor"]) if spec["factor"] else cfg


def leaves(tree, prefix=""):
    if tree is None:
        return {}
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = (tree.items() if isinstance(tree, dict) else
             zip(tree._fields, tree) if hasattr(tree, "_fields") else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def close(fails, what, got, want, rtol, atol):
    g, w = leaves(got), leaves(want)
    if sorted(g) != sorted(w):
        fails.append(f"{what}: leaves {sorted(set(g) ^ set(w))}")
        return
    for k in w:
        a, b = g[k], w[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            fails.append(f"{what} {k}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
        elif a.is_floating_point():
            if not torch.allclose(a, b, rtol=rtol, atol=atol):
                fails.append(f"{what} {k}: max abs {float((a - b).abs().max()):.3e}")
        elif not torch.equal(a, b):
            fails.append(f"{what} {k}: integers differ")


def batch_of(cfg, seed, masked):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if masked:
        b["labels"][0, :3] = -100
    if cfg.family == "vlm":
        b["prefix"] = rng.standard_normal((B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        b["frames"] = frames_of(cfg, rng, S)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def frames_of(cfg, rng, seq):
    return rng.standard_normal((B, seq // cfg.encoder_ratio, cfg.d_model)).astype(np.float32)


def step_case(arch, kind, strategy, mb):
    cfg = config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    # split: the single-device microbatches that route the MoE as this step does
    split = mb * (D if strategy != "fsdp" and cfg.family == "moe" else 1)
    # the mean of the microbatches' cross entropies is the batch's only when
    # each holds as many labelled positions
    batch = batch_of(cfg, 1, masked=split == 1)
    fails = []
    if kind == "train":
        shape = InputShape("t", S, B, "train")
        fn, _, in_sh, out_sh = build_sharded_step(cfg, shape, bm, strategy, microbatches=mb)
        opt = adam_init_f32(params)
        p, o, loss = fn(shard_tree(params, in_sh[0]), shard_tree(opt, in_sh[1]),
                        shard_tree(batch, in_sh[2]))
        p, o = gather_tree(p, out_sh[0]), gather_tree(o, out_sh[1])
        if rank:
            return fails
        # the config the step runs: the train shape's (no sliding window, which
        # a VLM's prefix would reach)
        wp, wo, wloss = make_train_step(cfg_for_shape(cfg, shape), microbatches=split)(
            params, opt, batch)
        if abs(float(loss) - float(wloss)) > 1e-5 * abs(float(wloss)):
            fails.append(f"loss {float(loss)!r} vs {float(wloss)!r}")
        if int(o.step) != int(wo.step):
            fails.append("step count")
        for name, got, want in (("mu", o.mu, wo.mu), ("nu", o.nu, wo.nu)):
            g, w = leaves(got), leaves(want)
            for k in w:
                if not torch.allclose(g[k], w[k], rtol=1e-5, atol=1e-5 * float(w[k].abs().max())):
                    fails.append(f"{name} {k}: max abs {float((g[k] - w[k]).abs().max()):.3e}")
        g, w, grad = leaves(p), leaves(wp), leaves(wo.mu)
        for k in w:
            a, b = g[k], w[k]
            firm = 10 * grad[k].abs() >= 1e-6           # mu = (1 - b1) g after one step
            if a.dtype != b.dtype or not torch.allclose(a[firm], b[firm], rtol=1e-5,
                                                        atol=1e-5 * LR):
                fails.append(f"params {k}: firm max abs {float((a - b)[firm].abs().max()):.3e}")
            if float((a - b).abs().max()) > 2 * LR:
                fails.append(f"params {k}: beyond 2 lr")
        return fails
    if kind == "prefill":
        fn, _, in_sh, out_sh = build_sharded_step(cfg, InputShape("p", S, B, "prefill"), bm,
                                                  strategy)
        pb = {k: v for k, v in batch.items() if k != "labels"}
        logits, cache = fn(shard_tree(params, in_sh[0]), shard_tree(pb, in_sh[1]))
        cache = gather_tree(cache, out_sh[1])
        if rank:
            return fails
        want = make_prefill_step(cfg, S)(params, pb)
        close(fails, "prefill", (logits, cache), want, 1e-4, 1e-5)
        return fails
    # decode: one token against a cache the single-device prefill filled
    n_cache = S + 8 + (cfg.prefix_len if cfg.family == "vlm" else 0)
    fn, _, in_sh, out_sh = build_sharded_step(cfg, InputShape("d", n_cache, B, "decode"), bm,
                                              strategy)
    pb = {k: v for k, v in batch.items() if k != "labels"}
    if cfg.is_encdec:       # the encoder memory the decode shape's cache holds
        pb["frames"] = torch.from_numpy(frames_of(cfg, np.random.default_rng(2), n_cache))
    _, cache = make_prefill_step(cfg, n_cache)(params, pb)
    tok = batch["tokens"][:, -1:]
    logits, new = fn(shard_tree(params, in_sh[0]), shard_tree(cache, in_sh[1]),
                     shard_tree(tok, in_sh[2]))
    logits, new = gather_tree(logits, out_sh[0]), gather_tree(new, out_sh[1])
    if rank:
        return fails
    close(fails, "decode", (logits, new), make_decode_step(cfg)(params, cache, tok), 1e-4, 1e-5)
    return fails


def moe_case():
    cfg = config("granite-moe-1b-a400m")
    z = np.load(f"{out_dir}/moe_inputs.npz")
    x = torch.from_numpy(z["x"])
    full = {"router": {"w": torch.from_numpy(z["router"])},
            "experts": {k: {"w": torch.from_numpy(z[k])} for k in ("w_gate", "w_up", "w_down")}}
    xs = bm.shard(x, P("data")).clone().requires_grad_()
    router = full["router"]["w"].clone().requires_grad_()
    experts = {k: bm.shard(v["w"], P("model")).clone().requires_grad_()
               for k, v in full["experts"].items()}
    p = {"router": {"w": router}, "experts": {k: {"w": v} for k, v in experts.items()}}
    wrt = [xs, router] + [experts[k] for k in ("w_gate", "w_up", "w_down")]
    with pspec.running(bm, bm, ("data",)):
        out, aux = moe_ffn_sharded(p, cfg, xs, bm)
        sq = bm.psum(torch.sum(out ** 2), ("data",))   # the loss over the whole batch
        g_sq = torch.autograd.grad(sq, wrt, retain_graph=True)
        g_all = torch.autograd.grad(sq + aux["moe_aux_loss"], wrt)

    def whole(g):   # grads of x by rows; the router summed; experts summed, then stacked
        x_, r_, *e_ = g
        return [bm.gather(x_, P("data")), bm.all_reduce(r_, ("data",))] + [
            bm.gather(bm.all_reduce(e, ("data",)), P("model")) for e in e_]

    res = {"out": bm.gather(out.detach(), P("data")), "aux": aux["moe_aux_loss"].detach(),
           "drop": aux["moe_drop_frac"], "g_sq": whole(g_sq), "g_all": whole(g_all)}
    if rank:
        return None
    xd = x.clone().requires_grad_()
    pd = {"router": {"w": full["router"]["w"].clone().requires_grad_()},
          "experts": {k: {"w": v["w"].clone().requires_grad_()} for k, v in full["experts"].items()}}
    od, ad = moe_ffn_dense(pd, cfg, xd)
    gd = torch.autograd.grad(torch.sum(od ** 2), [xd, pd["router"]["w"]] + [
        pd["experts"][k]["w"] for k in ("w_gate", "w_up", "w_down")])
    res["dense"] = {"out": od.detach(), "aux": ad["moe_aux_loss"].detach(), "g_sq": list(gd),
                    "drop": ad["moe_drop_frac"]}
    return res


try:
    results = {"moe": moe_case(), "steps": {}}
    for case in spec["steps"]:
        results["steps"]["/".join(map(str, case))] = step_case(*case)
    if rank == 0:
        results["traffic"] = bm.traffic
        torch.save(results, f"{out_dir}/results.pt")
finally:
    dist.destroy_process_group()
"""

REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models.moe import moe_ffn_sharded
out_dir = sys.argv[1]
z = np.load(f"{out_dir}/moe_inputs.npz")
res = {}
for tag, shape, factor in (("22", (2, 2), None), ("12", (1, 2), float(sys.argv[2]))):
    cfg = get_config("granite-moe-1b-a400m").reduced()
    if factor:
        cfg = dataclasses.replace(cfg, moe_capacity_factor=factor)
    mesh = jax.make_mesh(shape, ("data", "model"), devices=jax.devices()[:shape[0] * shape[1]])
    p = {"router": {"w": z["router"]},
         "experts": {k: {"w": z[k]} for k in ("w_gate", "w_up", "w_down")}}

    def loss(p, x):
        out, aux = moe_ffn_sharded(p, cfg, x, mesh)
        return jnp.sum(out ** 2) + aux["moe_aux_loss"], (out, aux["moe_aux_loss"])

    with mesh:
        (_, (out, aux)), g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            p, z["x"])
    res[f"{tag}_out"], res[f"{tag}_aux"] = np.asarray(out), np.asarray(aux)
    res[f"{tag}_gx"], res[f"{tag}_grouter"] = np.asarray(g[1]), np.asarray(g[0]["router"]["w"])
    for k in ("w_gate", "w_up", "w_down"):
        res[f"{tag}_g{k}"] = np.asarray(g[0]["experts"][k]["w"])
np.savez(f"{out_dir}/reference.npz", **res)
print("REFERENCE_OK")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return env


def _moe_inputs(path):
    """x, router and experts of reduced granite (d 256, E 4, ff 512)."""
    from repro_torch.configs import get_config

    cfg = get_config("granite-moe-1b-a400m").reduced()
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
    rng = np.random.default_rng(7)
    router = (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32)
    # tokens lean towards expert 0, so granite's own capacity factor drops some
    lean = 2.0 * router[:, 0] / np.linalg.norm(router[:, 0])
    arrays = {"x": (rng.standard_normal(MOE_SHAPE + (d,)) + lean).astype(np.float32),
              "router": router}
    for k, (a, b) in (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d))):
        arrays[k] = (rng.standard_normal((E, a, b)) * a ** -0.5).astype(np.float32)
    np.savez(path, **arrays)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gangs and the reference, run together; rank 0's results of each
    and the reference's arrays."""
    import torch

    dirs = {mesh: tmp_path_factory.mktemp(f"mesh{mesh[0]}{mesh[1]}") for mesh in ((2, 2), (1, 2))}
    for d in dirs.values():
        _moe_inputs(d / "moe_inputs.npz")
    codes = {}

    def gang(mesh):
        codes[mesh] = mp.launch(
            [sys.executable, "-c", WORKER, str(dirs[mesh]), json.dumps(_cases(mesh))],
            processes=mesh[0] * mesh[1], devices_per_process=1, timeout=SPAWN_TIMEOUT,
            env=_env())

    threads = [threading.Thread(target=gang, args=(m,)) for m in dirs]
    for t in threads:
        t.start()
    ref = subprocess.run([sys.executable, "-c", REFERENCE, str(dirs[(2, 2)]),
                          str(GRANITE_FACTOR)], env=_env(), capture_output=True, text=True,
                         timeout=SPAWN_TIMEOUT)
    for t in threads:
        t.join(timeout=SPAWN_TIMEOUT + 30)
        assert not t.is_alive(), "a gang outlived its timeout"
    assert codes == {(2, 2): 0, (1, 2): 0}, f"the gangs exited {codes}"
    assert ref.returncode == 0 and "REFERENCE_OK" in ref.stdout, ref.stderr[-3000:]
    return ({mesh: torch.load(d / "results.pt") for mesh, d in dirs.items()},
            dict(np.load(dirs[(2, 2)] / "reference.npz")))


VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL = 1e-3                     # tests/test_torch_lm_models.py
GRAD_NAMES = ("x", "router", "w_gate", "w_up", "w_down")


def _grads_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=1e-5 * np.abs(want).max(),
                               err_msg=name)


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
def test_moe_sharded_matches_dense(runs, mesh):
    res = runs[0][mesh]["moe"]
    dense = res["dense"]
    np.testing.assert_allclose(res["out"].numpy(), dense["out"].numpy(), **VALUE_TOL)
    for name, got, want in zip(GRAD_NAMES, res["g_sq"], dense["g_sq"]):
        _grads_close(got.numpy(), want.numpy(), name)
    assert float(res["drop"]) == 0.0                      # reported as 0, as the reference
    if mesh == (1, 2):
        # one data shard routes the whole batch: the aux loss is the dense one,
        # and granite's capacity factor drops tokens alike in both
        np.testing.assert_allclose(float(res["aux"]), float(dense["aux"]), **VALUE_TOL)
        assert float(dense["drop"]) > 0.0
    else:
        assert float(dense["drop"]) == 0.0


@pytest.mark.parametrize("mesh", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
def test_moe_sharded_matches_the_reference(runs, mesh):
    """Forward, aux loss and the grads of sum(out^2) + aux against the
    reference's moe_ffn_sharded under jit on the same mesh shape."""
    res, ref = runs[0][mesh]["moe"], runs[1]
    tag = f"{mesh[0]}{mesh[1]}"
    np.testing.assert_allclose(res["out"].numpy(), ref[f"{tag}_out"], **VALUE_TOL)
    np.testing.assert_allclose(float(res["aux"]), float(ref[f"{tag}_aux"]), **VALUE_TOL)
    for name, got in zip(GRAD_NAMES, res["g_all"]):
        _grads_close(got.numpy(), ref[f"{tag}_g{name}"], name)


STEP_CASES = [(mesh, case) for mesh in ((2, 2), (1, 2)) for case in _cases(mesh)["steps"]]


@pytest.mark.parametrize("mesh,case", STEP_CASES,
                         ids=[f"{m[0]}x{m[1]}-{_case_id(c)}" for m, c in STEP_CASES])
def test_sharded_step_matches_single_device(runs, mesh, case):
    fails = runs[0][mesh]["steps"]["/".join(map(str, case))]
    assert fails == [], fails


@pytest.mark.parametrize("shape", [(7, 5, 3), (50, 20), (3,), ()])
def test_adam_in_slices_equals_adam_update(monkeypatch, shape):
    """A sharded step applies AdamW to a large block a leading slice at a
    time; elementwise, so bit for bit ``adam_update`` on the whole block
    (a bf16 param comes back float32 either way)."""
    import torch

    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamState, adam_update

    monkeypatch.setattr(steps, "ADAM_CHUNK_BYTES", 100)
    gen = torch.Generator().manual_seed(0)
    g, m, v = (torch.randn(shape, generator=gen) for _ in range(3))
    p = torch.randn(shape, generator=gen).to(torch.bfloat16)
    step = torch.tensor(3, dtype=torch.int32)
    got = steps._adam_slices(g, m, v.abs(), p, step)
    x, st = adam_update(g, AdamState(step, m, v.abs()), p, steps.LR, weight_decay=steps.WD)
    for a, b in zip(got, (x, st.mu, st.nu)):
        assert a.dtype == b.dtype and torch.equal(a, b)
