"""The dry-run's per-device program cost (``analysis/program.py``): one
rank's sharded step traced over meta tensors, against the reference's
``analyze_hlo`` of the compiled program and against the collectives a real
call moves on gloo CPU ranks.

* Flops: ``tests/test_dryrun.py``'s reduced configs and shapes (train_4k cut
  to seq 64 x batch 4, decode_32k to seq 128 x batch 4) on (1, 1), (2, 1),
  (1, 2) and (2, 2) meshes: on a model axis of 2 each rank computes with
  its blocks, as GSPMD partitions the reference's products. The reference
  compiles each step in one subprocess with 4 forced host devices (not
  granite's train step, which does not compile there: ROADMAP Queue 3);
  the traced per-device flops must equal its ``analyze_hlo`` flops within
  1%. Three archs differ, each by a dot that one side counts and the other
  does not:

  - rwkv6-1.6b train, -0.55% (-0.50% on a model axis of 2): the reference
    forms k_t v_t^T as ``einsum("bhk,bhv->bhkv")``, a dot with no
    contraction that ``hlo_graph`` counts (2·B·H·hd² a step); the port
    multiplies by broadcasting, which the dot rule does not count.
  - hymba-1.5b train, +0.08%: the vjp of the selective scan's
    ``einsum("bdn,bn->bd")`` with respect to h is an outer product, which
    torch runs as a bmm with a contraction of 1 (2·B·d_inner·n a step) and
    XLA rewrites as a multiply.
  - granite-moe-1b-a400m decode on a model axis of 2, -0.26% (524,288
    flops): the reference's program all-gathers the head (256 x 512
    float32, its only all-gather) and computes every vocab column on each
    rank; the port computes its block of the vocab and gathers the logits.

  No leaf is gathered under ``launch.steps.tp_gathers``' rule in these
  cases (their heads divide the axis). A reduced yi-6b train step on (2, 2)
  traces 6.5431e8 flops per device, the reference's. yi-6b's (2, 1) train
  all-reduce bytes equal the reference's exactly.
* No param gathers: the traced megatron train and decode steps and the
  zero1 train step of seven reduced archs on (1, 2) and (2, 2) all-gather no
  param leaf over the model axis but the ones ``tp_gathers`` lists
  (paligemma-3b's single KV head: ``wk``, ``wv``; hymba-1.5b's Mamba
  ``in_proj``); at model 16 the rule lists the leaves whose blocks cut
  inside a head. In the gangs below, no real megatron or zero1 call gathers
  a param leaf over model.
* Collectives: on (2, 1), (1, 2) and (2, 2) gangs of gloo CPU ranks
  (started once each through ``launch.multiprocess.launch``, as in
  ``tests/test_torch_mesh_steps.py``), for reduced yi-6b and
  granite-moe-1b-a400m, the train step under megatron, zero1 and fsdp and
  the prefill and decode steps under each: every rank's ``BoundMesh.traffic``
  after one real call equals the calls and bytes of the same rank's
  trace, and ``parse_collectives`` of its listing; the param leaves the
  call all-gathers over model are recorded.
* The loop helper (``models.layers.time_scan``): rwkv6 and hymba at S = 64
  count with the scaled loop exactly the flops and transcendentals of the
  unrolled loop, forward (prefill) and forward + backward (train); the
  helper's values and grads equal the loops it replaced bit for bit.
* rwkv6-1.6b ``prefill_32k`` on 16x16 traces in under 30 s.
"""
import json
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch._tree import tree_leaves
from repro_torch.analysis.hlo import parse_collectives
from repro_torch.analysis.program import trace_step
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import multiprocess as mp
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.launch.steps import build_sharded_step
from repro_torch.models import build_model
from repro_torch.models import hybrid, layers, rwkv

from test_torch_mesh_steps import SPAWN_TIMEOUT, _env

torch.set_num_threads(1)

TRAIN = InputShape("train_4k", 64, 4, "train")        # tests/test_dryrun.py's SHAPE
DECODE = InputShape("decode_32k", 128, 4, "decode")   # and DEC
FLOP_RTOL = 0.01
REFERENCE_PROCESSES = 3              # the reference compiles FLOP_CASES in this many processes
FLOP_CASES = [(a, k, m) for m in ((1, 1), (2, 1), (1, 2), (2, 2))
              for a in ("yi-6b", "rwkv6-1.6b", "hymba-1.5b", "seamless-m4t-large-v2",
                        "granite-moe-1b-a400m")
              for k in ("train", "decode") if (a, k) != ("granite-moe-1b-a400m", "train")]

REFERENCE = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax
from repro.analysis.hlo_graph import analyze_hlo
from repro.configs import INPUT_SHAPES, get_config
from repro.launch.steps import build_sharded_step

SHAPES = {"train": dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=64, global_batch=4),
          "decode": dataclasses.replace(INPUT_SHAPES["decode_32k"], seq_len=128, global_batch=4)}
out = {}
for arch, kind, ms in json.loads(sys.argv[1]):
    mesh = jax.make_mesh(tuple(ms), ("data", "model"), devices=jax.devices()[:ms[0] * ms[1]])
    fn, args, in_sh, out_sh = build_sharded_step(get_config(arch).reduced(), SHAPES[kind], mesh)
    with mesh:
        compiled = jax.jit(fn, in_shardings=in_sh, out_shardings=out_sh).lower(*args).compile()
    out[f"{arch}/{kind}/{ms[0]}x{ms[1]}"] = analyze_hlo(compiled.as_text()).to_dict()
print("REFERENCE " + json.dumps(out))
"""

# One rank of a gang: each case's real call on its blocks, then the same
# rank's trace of the same step, built on the mesh's description.
WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch import multiprocess as mp
rank, nproc, _ = mp.initialize_worker(device="cpu")
import torch.distributed as dist
from repro_torch._tree import tree_leaves
from repro_torch.analysis.hlo import parse_collectives
from repro_torch.analysis.program import trace_step
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import bind_mesh, make_debug_mesh
from repro_torch.launch.sharding import map_with_path, shard_tree
from repro_torch.launch.steps import adam_init_f32, build_sharded_step, make_prefill_step
from repro_torch.models import build_model

gathered = []                   # (id of the gathered block, the axes) of each all_gather
_gather = mesh_mod.RankView.gather


def gather(self, x, spec, axes=None):
    gathered.append((id(x), [a for d in mesh_mod.spec_axes(spec, x.ndim) for a in d]
                     if axes is None else list(axes)))
    return _gather(self, x, spec, axes)


mesh_mod.RankView.gather = gather

out_dir, spec = sys.argv[1], json.loads(sys.argv[2])
B, S = 4, 16
mesh = make_debug_mesh(*spec["mesh"])
bm = bind_mesh(mesh)
res = {}
try:
    for arch, kind, strategy in spec["cases"]:
        cfg = get_config(arch).reduced()
        params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        tokens = torch.from_numpy(
            np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
        shape = InputShape(kind, S, B, kind)
        if kind == "train":
            inputs = (params, adam_init_f32(params), {"tokens": tokens, "labels": tokens})
        elif kind == "prefill":
            inputs = (params, {"tokens": tokens})
        else:       # one token against the S-deep cache of the prompt
            _, cache = make_prefill_step(cfg, S)(params, {"tokens": tokens})
            inputs = (params, cache, tokens[:, -1:])
        fn, _, in_sh, _ = build_sharded_step(cfg, shape, bm, strategy)
        for k in bm.traffic:
            bm.traffic[k] = {"calls": 0, "bytes": 0}
        blocks = [shard_tree(x, sh) for x, sh in zip(inputs, in_sh)]
        paths = {id(t): p for p, t in zip(tree_leaves(map_with_path(lambda p, t: p, blocks[0])),
                                          tree_leaves(blocks[0]))}
        gathered.clear()
        fn(*blocks)
        param_gathers = sorted({paths[i] for i, axes in gathered if i in paths and "model" in axes})
        fn, args, in_sh, _ = build_sharded_step(cfg, shape, mesh, strategy)
        cost, listing, _ = trace_step(fn, args, in_sh, mesh, rank)
        res["/".join((arch, kind, strategy))] = {
            "measured": {k: dict(v) for k, v in bm.traffic.items()},
            "traced": {"bytes": cost.collective_by_kind, "calls": cost.collective_calls_by_kind},
            "parsed": parse_collectives(listing).to_dict(), "param_gathers": param_gathers}
    with open(f"{out_dir}/rank{rank}.json", "w") as f:
        json.dump(res, f)
finally:
    dist.destroy_process_group()
"""

GANG_MESHES = ((2, 1), (1, 2), (2, 2))
GANG_CASES = [(a, k, s) for a in ("yi-6b", "granite-moe-1b-a400m")
              for k in ("train", "prefill", "decode") for s in ("megatron", "zero1", "fsdp")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gangs and the reference, run together: every rank's records of
    each gang, and the reference's ``analyze_hlo`` of each flop case."""
    dirs = {m: tmp_path_factory.mktemp(f"gang{m[0]}{m[1]}") for m in GANG_MESHES}
    codes = {}

    def gang(m):
        codes[m] = mp.launch(
            [sys.executable, "-c", WORKER, str(dirs[m]),
             json.dumps({"mesh": list(m), "cases": GANG_CASES})],
            processes=m[0] * m[1], devices_per_process=1, timeout=SPAWN_TIMEOUT, env=_env())

    threads = [threading.Thread(target=gang, args=(m,)) for m in GANG_MESHES]
    for t in threads:
        t.start()
    # the reference's compiles, in REFERENCE_PROCESSES processes side by side
    refs = [subprocess.Popen([sys.executable, "-c", REFERENCE,
                              json.dumps(FLOP_CASES[i::REFERENCE_PROCESSES])], env=_env(),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(REFERENCE_PROCESSES)]
    outs = [p.communicate(timeout=SPAWN_TIMEOUT) for p in refs]
    for t in threads:
        t.join(timeout=SPAWN_TIMEOUT + 30)
        assert not t.is_alive(), "a gang outlived its timeout"
    assert codes == {m: 0 for m in GANG_MESHES}, f"the gangs exited {codes}"
    flops = {}
    for p, (out, err) in zip(refs, outs):
        assert p.returncode == 0, err[-3000:]
        line = next(x for x in out.splitlines() if x.startswith("REFERENCE "))
        flops.update(json.loads(line[len("REFERENCE "):]))
    ranks = {m: [json.loads((dirs[m] / f"rank{r}.json").read_text()) for r in range(m[0] * m[1])]
             for m in GANG_MESHES}
    return ranks, flops


def _trace(arch, shape, mesh, rank=0, **kwargs):
    m = make_debug_mesh(*mesh)
    fn, args, in_sh, _ = build_sharded_step(get_config(arch).reduced(), shape, m)
    return trace_step(fn, args, in_sh, m, rank, **kwargs)


# ---------------------------------------------------------------------------
# Against the reference's compiled program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind,mesh", FLOP_CASES,
                         ids=[f"{a}-{k}-{m[0]}x{m[1]}" for a, k, m in FLOP_CASES])
def test_traced_flops_match_the_reference(runs, arch, kind, mesh):
    want = runs[1][f"{arch}/{kind}/{mesh[0]}x{mesh[1]}"]["flops"]
    cost, _, _ = _trace(arch, TRAIN if kind == "train" else DECODE, mesh)
    assert cost.flops == pytest.approx(want, rel=FLOP_RTOL)


def test_yi_all_reduce_bytes_equal_the_reference(runs):
    want = runs[1]["yi-6b/train/2x1"]["collective_by_kind"]["all-reduce"]
    cost, listing, _ = _trace("yi-6b", TRAIN, (2, 1))
    assert want == 5_772_296
    assert cost.collective_by_kind["all-reduce"] == want
    assert parse_collectives(listing).bytes_by_kind["all-reduce"] == want


# ---------------------------------------------------------------------------
# Against the collectives of a real call
# ---------------------------------------------------------------------------

GANG_PARAMS = [(m, c) for m in GANG_MESHES for c in GANG_CASES]


@pytest.mark.parametrize("mesh,case", GANG_PARAMS,
                         ids=[f"{m[0]}x{m[1]}-" + "-".join(c) for m, c in GANG_PARAMS])
def test_traced_collectives_equal_the_measured_traffic(runs, mesh, case):
    for r, rec in enumerate(runs[0][mesh]):
        got = rec["/".join(case)]
        measured = {kind.replace("_", "-"): t for kind, t in got["measured"].items() if t["calls"]}
        assert got["traced"]["bytes"] == {k: t["bytes"] for k, t in measured.items()}, r
        assert got["traced"]["calls"] == {k: t["calls"] for k, t in measured.items()}, r
        assert got["parsed"]["bytes_by_kind"] == got["traced"]["bytes"], r
        assert got["parsed"]["count_by_kind"] == got["traced"]["calls"], r


@pytest.mark.parametrize("mesh", GANG_MESHES, ids=[f"{m[0]}x{m[1]}" for m in GANG_MESHES])
def test_real_tensor_parallel_calls_gather_no_param(runs, mesh):
    """Every rank's real megatron and zero1 calls (train, prefill, decode)
    all-gather no param leaf over model: each computes with its blocks."""
    for r, rec in enumerate(runs[0][mesh]):
        for case, got in rec.items():
            if not case.endswith("/fsdp"):
                assert got["param_gathers"] == [], (r, case)


# The leaves tp_gathers names for the reduced archs on a model axis of 2.
RULE_LEAVES = {"paligemma-3b": ["layers/attn/wk/w", "layers/attn/wv/w"],
               "hymba-1.5b": ["layers/hymba/mamba/in_proj/w"]}
TP_ARCHS = ("yi-6b", "chatglm3-6b", "paligemma-3b", "rwkv6-1.6b", "hymba-1.5b",
            "seamless-m4t-large-v2", "granite-moe-1b-a400m")


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_traced_tensor_parallel_steps_gather_only_the_rule_leaves(monkeypatch, arch, mesh):
    """The traced megatron train and decode steps and the zero1 train step
    all-gather over model only the param leaves ``fn.gathered`` lists, and
    those are the rule's (``RULE_LEAVES``)."""
    from repro_torch.analysis import program
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.sharding import map_with_path

    seen, blocks = [], []
    gather, block_specs = mesh_mod.RankView.gather, program.block_specs

    def spy(self, x, spec, axes=None):
        seen.append((id(x), [a for d in mesh_mod.spec_axes(spec, x.ndim) for a in d]
                     if axes is None else list(axes)))
        return gather(self, x, spec, axes)

    def keep(*args):
        blocks.append(block_specs(*args))
        return blocks[-1]

    monkeypatch.setattr(mesh_mod.RankView, "gather", spy)
    monkeypatch.setattr(program, "block_specs", keep)
    m = make_debug_mesh(*mesh)
    for shape, strategy in ((TRAIN, "megatron"), (DECODE, "megatron"), (TRAIN, "zero1")):
        fn, args, in_sh, _ = build_sharded_step(get_config(arch).reduced(), shape, m, strategy)
        seen.clear()
        trace_step(fn, args, in_sh, m, m.size - 1)
        params = blocks[-1][0]
        paths = {id(t): p for p, t in zip(
            tree_leaves(map_with_path(lambda p, t: p, params)), tree_leaves(params))}
        got = sorted({paths[i] for i, axes in seen if i in paths and "model" in axes})
        assert got == fn.gathered == RULE_LEAVES.get(arch, []), (shape.kind, strategy)


def test_the_gather_rule_at_model_16():
    """On 16x16 the rule lists the attention leaves whose blocks cut inside
    a head and Mamba's in_proj, and nothing under fsdp."""
    mesh = make_production_mesh()
    want = {
        "yi-6b": ["layers/attn/wk/w", "layers/attn/wv/w"],                 # 4 KV heads
        "chatglm3-6b": ["layers/attn/wk/b", "layers/attn/wk/w",           # 2 KV heads
                        "layers/attn/wv/b", "layers/attn/wv/w"],
        "paligemma-3b": ["layers/attn/wk/w", "layers/attn/wq/w",          # 8 heads, 1 KV
                         "layers/attn/wv/w"],
        "hymba-1.5b": ["layers/hymba/attn/wk/w", "layers/hymba/attn/wq/w",  # 25 heads, 5 KV
                       "layers/hymba/attn/wv/w", "layers/hymba/mamba/in_proj/w"],
        "rwkv6-1.6b": [],
        "seamless-m4t-large-v2": [],                                      # 16 KV heads
    }
    for arch, leaves in want.items():
        for strategy in ("megatron", "zero1", "fsdp"):
            fn, _, _, _ = build_sharded_step(get_config(arch), INPUT_SHAPES["decode_32k"], mesh,
                                             strategy)
            assert sorted(fn.gathered) == (leaves if strategy != "fsdp" else []), (arch, strategy)


def test_parse_collectives_reads_the_listing():
    """(2, 2) yi-6b train: both kinds, each line written as HLO writes it."""
    cost, listing, _ = _trace("yi-6b", TRAIN, (2, 2), rank=3)
    stats = parse_collectives(listing)
    assert set(stats.bytes_by_kind) == {"all-reduce", "all-gather"}
    assert stats.bytes_by_kind == cost.collective_by_kind
    assert stats.count_by_kind == cost.collective_calls_by_kind
    assert stats.total_bytes == cost.collective_bytes
    lines = [x for x in listing.splitlines() if " all-gather(" in x]
    assert len(lines) == cost.collective_calls_by_kind["all-gather"]
    assert re.match(r"\s+%\d+ = \w+\[[\d,]*\] all-gather\(\w+\[[\d,]*\]\), replica_groups=\{",
                    lines[0])


# ---------------------------------------------------------------------------
# The loop helper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "hymba-1.5b"])
@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_scaled_loops_count_what_the_unrolled_loops_count(arch, kind):
    shape = InputShape(kind, 64, 4, kind)
    scaled, listing, _ = _trace(arch, shape, (1, 1))
    unrolled, flat, _ = _trace(arch, shape, (1, 1), scale_loops=False)
    assert scaled.flops == unrolled.flops and scaled.flops > 0
    assert scaled.transcendentals == unrolled.transcendentals
    assert unrolled.flops_unscaled == unrolled.flops
    assert scaled.flops_unscaled < scaled.flops
    # one body a layer (and a recompute and a vjp a layer when training)
    bodies = listing.count("while trip_count=64 {")
    assert bodies == get_config(arch).reduced().num_layers * (3 if kind == "train" else 1)
    assert "while" not in flat and len(flat) > len(listing)


def _old_wkv(S_st, xs, consts):
    """The time loop ``rwkv_layer_seq`` ran before ``time_scan``."""
    kh, vh, rh, wh = xs
    (uh,) = consts
    ys = []
    for t in range(kh.shape[1]):
        kv = kh[:, t, :, :, None] * vh[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rh[:, t], S_st + uh * kv))
        S_st = wh[:, t, :, :, None] * S_st + kv
    return S_st, torch.stack(ys, dim=1)


def _old_ssm(h, xs, consts):
    """The time loop ``hybrid._ssm_scan`` ran before ``time_scan``."""
    decay, inp, Cm = xs
    ys = []
    for t in range(decay.shape[1]):
        h = decay[:, t] * h + inp[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return h, torch.stack(ys, dim=1)


@pytest.mark.parametrize("arch,module,old", [("rwkv6-1.6b", rwkv, _old_wkv),
                                             ("hymba-1.5b", hybrid, _old_ssm)])
def test_time_scan_is_the_loop_it_replaced(monkeypatch, arch, module, old):
    """The model's loss runs its time loops through ``time_scan``: each
    call's carry and ys, and the grads of both with respect to every input,
    equal the old loop's on the same tensors bit for bit."""
    calls = []

    def spy(step, carry, xs, consts=()):
        inputs = [t.detach().requires_grad_() for t in (carry, *xs, *consts)]
        calls.append((step, len(xs), inputs))
        return layers.time_scan(step, carry, xs, consts)

    monkeypatch.setattr(module, "time_scan", spy)
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32))
    model.loss(params, {"tokens": tokens, "labels": tokens})
    assert len(calls) == cfg.num_layers
    for step, n_x, inputs in calls:
        carry, xs, consts = inputs[0], tuple(inputs[1:1 + n_x]), tuple(inputs[1 + n_x:])
        got = layers.time_scan(step, carry, xs, consts)
        want = old(carry, xs, consts)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        weights = [torch.randn(t.shape, generator=torch.Generator().manual_seed(1)) for t in got]
        g_got = torch.autograd.grad(sum((a * w).sum() for a, w in zip(got, weights)), inputs)
        g_want = torch.autograd.grad(sum((b * w).sum() for b, w in zip(want, weights)), inputs)
        for a, b in zip(g_got, g_want):
            assert torch.equal(a, b)


def test_rwkv_prefill_32k_traces_in_under_30_s():
    mesh = make_production_mesh()
    fn, args, in_sh, _ = build_sharded_step(get_config("rwkv6-1.6b"),
                                            InputShape("prefill_32k", 32_768, 32, "prefill"), mesh)
    t0 = time.perf_counter()
    cost, listing, temp = trace_step(fn, args, in_sh, mesh)
    assert time.perf_counter() - t0 < 30
    assert cost.flops > 0 and temp > 0 and "while trip_count=32768 {" in listing
