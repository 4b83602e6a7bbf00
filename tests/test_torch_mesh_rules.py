"""The port's mesh rules and roofline arithmetic against the JAX package's,
on the CPU in one process (no ranks).

* Placements: the reference's ``build_sharded_step`` runs in a subprocess
  on 512 forced host devices, builds NamedShardings only (nothing is
  lowered or compiled) and prints every in and out placement as JSON
  keyed by path, for the ten assigned archs x the four input shapes x the
  16x16 and 2x16x16 production meshes x megatron, zero1 and fsdp: params,
  Adam moments, batch, decode tokens and caches, prefill caches and
  logits. The port's ``build_sharded_step`` on the same mesh descriptions
  must give the same spec for every leaf.
* ``tests/test_sharding_rules.py``'s assertions, restated on the port.
* ``pspec.fitted_spec`` against the spec the reference's ``constrain``
  hands ``with_sharding_constraint``.
* ``model_flops``, ``model_traffic``, ``active_params``, ``total_params``
  and ``roofline_terms`` (under the reference's TPU v5e constants) equal to
  the reference's for every arch x shape.
* The dry-run: its records carry the reference's schema
  (``src/repro/launch/dryrun.py``, ``tests/test_launchers.py:63-91``) less
  the fields that need XLA; the CLI writes 40 ``ok`` records and the
  report prints their table; specs allocate nothing.
"""
import json
import os
import subprocess
import sys
import types
from collections.abc import Mapping

import jax
import numpy as np
import pytest
import torch

from repro.analysis import hlo as j_hlo
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import pspec as j_pspec
from repro_torch._tree import tree_leaves
from repro_torch.analysis import hlo
from repro_torch.analysis import report
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, pspec
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import Mesh, data_axes, make_debug_mesh, make_production_mesh
from repro_torch.launch.sharding import NamedSharding, P
from repro_torch.launch.specs import cache_specs, param_specs
from repro_torch.launch.steps import build_sharded_step

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"16x16": False, "2x16x16": True}
STRATEGIES = ("megatron", "zero1", "fsdp")

REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax
from jax.sharding import NamedSharding
from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import build_sharded_step


def canon(spec):
    return [e[0] if isinstance(e, tuple) and len(e) == 1 else
            list(e) if isinstance(e, tuple) else e for e in spec]


def key(k):
    for a in ("key", "name", "idx"):
        if hasattr(k, a):
            return str(getattr(k, a))
    return str(k)


out = {}
for tag, multi in (("16x16", False), ("2x16x16", True)):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ASSIGNED_ARCHS:
        for sname, shape in INPUT_SHAPES.items():
            for strategy in ("megatron", "zero1", "fsdp"):
                _, _, in_sh, out_sh = build_sharded_step(get_config(arch), shape, mesh,
                                                         strategy=strategy)
                for side, tree in (("in", in_sh), ("out", out_sh)):
                    flat, _ = jax.tree_util.tree_flatten_with_path(
                        tree, is_leaf=lambda x: isinstance(x, NamedSharding))
                    for path, sh in flat:
                        out["/".join([tag, arch, sname, strategy, side]
                                     + [key(k) for k in path])] = canon(sh.spec)
print("SPECS " + json.dumps(out))
"""


def _canon(spec):
    return [e[0] if isinstance(e, tuple) and len(e) == 1 else
            list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, prefix):
    """{path: canonical spec} over a tree of NamedShardings."""
    if isinstance(tree, NamedSharding):
        return {prefix: _canon(tree.spec)}
    if isinstance(tree, Mapping):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


@pytest.fixture(scope="module")
def reference_specs():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", REFERENCE], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("SPECS "))
    return json.loads(line[len("SPECS "):])


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("tag", list(MESHES))
def test_placements_equal_the_reference_leaf_for_leaf(reference_specs, tag, arch):
    mesh = make_production_mesh(multi_pod=MESHES[tag])
    got = {}
    for sname, shape in INPUT_SHAPES.items():
        for strategy in STRATEGIES:
            _, _, in_sh, out_sh = build_sharded_step(get_config(arch), shape, mesh, strategy)
            for side, tree in (("in", in_sh), ("out", out_sh)):
                got.update(_flat(tree, "/".join([tag, arch, sname, strategy, side])))
    want = {k: v for k, v in reference_specs.items() if k.startswith(f"{tag}/{arch}/")}
    assert sorted(got) == sorted(want), sorted(set(got) ^ set(want))[:10]
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    assert not bad, list(bad.items())[:10]


# ---------------------------------------------------------------------------
# tests/test_sharding_rules.py, restated on the port
# ---------------------------------------------------------------------------

def test_sharding_rules():
    mesh = Mesh(("data", "model"), (4, 4))
    cfg = get_config("yi-6b")
    ps = param_specs(cfg, INPUT_SHAPES["train_4k"])
    sh = shd.param_shardings(mesh, ps)

    def spec_of(tree, path):
        for k in path:
            tree = tree[k]
        return tree.spec

    # embedding: vocab-sharded
    assert spec_of(sh, ("embed", "table")) == P("model", None)
    # attention projections: column-parallel (layer-stack leading dim replicated)
    assert spec_of(sh, ("layers", "attn", "wq", "w")) == P(None, None, "model")
    assert spec_of(sh, ("layers", "attn", "wo", "w")) == P(None, "model", None)
    # mlp
    assert spec_of(sh, ("layers", "mlp", "w_gate", "w")) == P(None, None, "model")
    assert spec_of(sh, ("layers", "mlp", "w_down", "w")) == P(None, "model", None)
    # norms replicated
    assert spec_of(sh, ("layers", "ln1", "scale")) == P(None, None)
    # moe expert parallelism: (L, E, d, ff)
    psm = param_specs(get_config("granite-moe-1b-a400m"), INPUT_SHAPES["train_4k"])
    shm = shd.param_shardings(mesh, psm)
    assert spec_of(shm, ("layers", "moe", "experts", "w_gate", "w")) == P(None, "model", None,
                                                                          None)
    # zero1 extends the model dim with the data axes
    z = shd.opt_shardings_zero1(mesh, ps)
    assert spec_of(z, ("layers", "mlp", "w_gate", "w")) == P(None, None, ("model", "data"))
    # decode cache: batch-sharded when divisible, KV heads on model
    c = cache_specs(cfg, INPUT_SHAPES["decode_32k"])
    assert shd.cache_shardings(mesh, cfg, c).kv.k.spec == P(None, "data", None, "model", None)
    # long_500k (B=1): the window context-parallel over data
    c1 = cache_specs(cfg, INPUT_SHAPES["long_500k"])
    assert shd.cache_shardings(mesh, cfg, c1).kv.k.spec == P(None, None, "data", "model", None)
    # the batch spec replicates a batch that does not divide
    assert shd.batch_spec(mesh, (1, 8)) == P(None, None)
    assert shd.batch_spec(mesh, (8, 16)) == P("data", None)


def test_meshes_are_descriptions():
    m = make_production_mesh()
    assert m.axis_names == ("data", "model") and m.shape == {"data": 16, "model": 16}
    assert m.devices.shape == (16, 16) and m.devices.size == 256 and data_axes(m) == ("data",)
    mp_ = make_production_mesh(multi_pod=True)
    assert mp_.devices.shape == (2, 16, 16) and data_axes(mp_) == ("pod", "data")
    d = make_debug_mesh(2, 2)
    assert d.axis_names == ("data", "model") and d.devices.tolist() == [[0, 1], [2, 3]]


def test_specs_allocate_nothing():
    ps = param_specs(get_config("dbrx-132b"), INPUT_SHAPES["train_4k"])
    assert all(x.is_meta for x in tree_leaves(ps))
    assert sum(x.numel() for x in tree_leaves(ps)) == 131_596_523_520
    c = cache_specs(get_config("yi-6b"), INPUT_SHAPES["long_500k"])
    assert all(x.is_meta for x in tree_leaves(c) if x is not None)


# ---------------------------------------------------------------------------
# constrain's fitted spec
# ---------------------------------------------------------------------------

CONSTRAIN_CASES = [
    ((16, 16), ("data", "model"), (32, 64, 8), (pspec.MODEL, pspec.DATA, None)),
    ((16, 16), ("data", "model"), (30, 64, 8), (pspec.MODEL, pspec.DATA, None)),
    ((16, 16), ("data", "model"), (32, 8), (pspec.MODEL, pspec.DATA)),
    ((2, 16, 16), ("pod", "data", "model"), (32, 64, 8), (pspec.MODEL, pspec.DATA, None)),
    ((2, 16, 16), ("pod", "data", "model"), (32, 16, 8), (pspec.MODEL, pspec.DATA)),
    ((2, 2), ("data", "model"), (6, 4, 3, 2), ("model", ("data", "model"))),
    ((4,), ("data",), (8, 8), (pspec.MODEL, pspec.DATA)),
]


@pytest.mark.parametrize("sizes,names,shape,axes", CONSTRAIN_CASES)
def test_constrain_fits_the_reference_spec(monkeypatch, sizes, names, shape, axes):
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, s: seen.append(s) or x)
    fake = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))
    try:
        j_pspec.set_active_mesh(fake)
        j_pspec.constrain(np.zeros(shape, np.float32), *axes)
    finally:
        j_pspec.set_active_mesh(None)
    x = torch.zeros(shape)
    with pspec.running(Mesh(names, sizes), None, ()):
        spec = pspec.fitted_spec(shape, *axes)
        assert pspec.constrain(x, *axes) is x
    assert _canon(spec) == _canon(seen[0])
    assert pspec.fitted_spec(shape, *axes) is None           # off a mesh


# ---------------------------------------------------------------------------
# Roofline arithmetic
# ---------------------------------------------------------------------------

V5E = dict(peak_flops=j_hlo.PEAK_FLOPS, hbm_bw=j_hlo.HBM_BW, link_bw=j_hlo.ICI_BW)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_roofline_arithmetic_equals_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert hlo.active_params(cfg) == j_hlo.active_params(jcfg)
    assert hlo.total_params(cfg) == j_hlo.total_params(jcfg)
    for name, shape in INPUT_SHAPES.items():
        jshape = J_SHAPES[name]
        for bwd in (False, True):
            assert hlo.model_flops(cfg, shape, bwd) == j_hlo.model_flops(jcfg, jshape, bwd)
        mt = hlo.model_traffic(cfg, shape)
        assert mt == j_hlo.model_traffic(jcfg, jshape)
        mf = hlo.model_flops(cfg, shape, shape.kind == "train")
        for chips in (1, 256, 512):
            args = (mf / chips, mt / chips, 1e9 * chips, chips)
            assert hlo.roofline_terms(*args, **V5E) == j_hlo.roofline_terms(*args)


def test_roofline_defaults_are_the_h100s():
    t = hlo.roofline_terms(989e12, 3.35e12, 900e9, 1)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 1.0,
                 "bottleneck": "compute"}


# ---------------------------------------------------------------------------
# The dry-run
# ---------------------------------------------------------------------------

# The reference's record (src/repro/launch/dryrun.py:46-121) and the fields
# that need XLA's compiled program.
REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "kind", "strategy", "status", "lower_s",
                  "compile_s", "memory_analysis", "cost_analysis", "hlo_bytes", "hlo_cost",
                  "model_traffic_global", "roofline", "model_flops_global",
                  "model_flops_per_chip", "useful_flops_ratio", "active_params",
                  "total_params", "total_s"}
XLA_ONLY = {"lower_s", "compile_s", "cost_analysis", "hlo_bytes", "hlo_cost",
            "useful_flops_ratio"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "bottleneck"}   # less collective_s, memory_s_hlo_upper


@pytest.mark.parametrize("arch,shape_name", [("yi-6b", "train_4k"),
                                             ("granite-moe-1b-a400m", "decode_32k"),
                                             ("rwkv6-1.6b", "prefill_32k")])
def test_dryrun_record_schema(arch, shape_name):
    """As tests/test_launchers.py:63-91: reduced configs and scaled shapes on
    a (2, 2) mesh, with the reference's schema less the XLA-only fields."""
    shape = InputShape(shape_name, 64, 4, INPUT_SHAPES[shape_name].kind)
    rec = dryrun.run_one(arch, shape_name, multi_pod=False, mesh=make_debug_mesh(2, 2),
                         cfg=get_config(arch).reduced(), shape=shape)
    assert rec["status"] == "ok", rec.get("error")
    assert set(rec) == REFERENCE_KEYS - XLA_ONLY
    assert rec["mesh"] == "2x2" and rec["chips"] == 4 and rec["kind"] == shape.kind
    assert set(rec["roofline"]) == ROOFLINE_KEYS
    assert rec["roofline"]["compute_s"] > 0 and rec["roofline"]["memory_s"] > 0
    assert set(rec["memory_analysis"]) == {"argument_size_in_bytes", "output_size_in_bytes"}
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["model_flops_global"] > 0 and rec["model_flops_per_chip"] > 0
    assert rec["active_params"] > 0 and rec["total_params"] > 0
    json.dumps(rec)


def test_dryrun_per_device_bytes():
    """dbrx-132b train_4k on 16x16: fsdp splits every bf16 param, its two
    float32 moments and the batch over all 256 devices (a leaf none of
    whose dims divides 256 stays whole); zero1 splits the moments finer
    than megatron."""
    got = {s: dryrun.run_one("dbrx-132b", "train_4k", False, s)["memory_analysis"][
        "argument_size_in_bytes"] for s in STRATEGIES}
    assert got["fsdp"] < got["zero1"] < got["megatron"]
    ps = param_specs(get_config("dbrx-132b"), INPUT_SHAPES["train_4k"])
    block = sum(x.numel() // (256 if any(n % 256 == 0 for n in x.shape) else 1)
                for x in tree_leaves(ps))
    assert got["fsdp"] == block * (2 + 4 + 4) + 2 * 256 * 4096 * 4 // 256 + 4


def test_dryrun_cli_writes_every_record_and_the_report_reads_them(tmp_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "all",
                          "--shape", "all", "--out", str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    recs = report.load_records(str(tmp_path))
    assert len(recs) == 40 and all(r["status"] == "ok" for r in recs)
    table = report.roofline_table(recs)
    assert len(table.splitlines()) == 42 and "| - |" in table
    refused = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--save-hlo",
                              str(tmp_path / "x.hlo")], env=env, capture_output=True, text=True,
                             timeout=120)
    assert refused.returncode == 2 and "no HLO" in refused.stderr


def test_refusals():
    """A sharded step needs a known strategy and a bound mesh; a mesh binds
    only to a process group of its size; the expert-parallel MoE needs a
    bound mesh to sum over."""
    from repro_torch.launch.mesh import bind_mesh
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_ffn

    cfg = get_config("granite-moe-1b-a400m").reduced()
    shape = InputShape("t", 8, 4, "train")
    with pytest.raises(ValueError, match="strategy"):
        build_sharded_step(cfg, shape, make_debug_mesh(2, 2), "zero3")
    fn, args, _, _ = build_sharded_step(cfg, shape, make_debug_mesh(2, 2))
    with pytest.raises(ValueError, match="bound"):
        fn(*args)
    with pytest.raises(ValueError, match="process group"):
        bind_mesh(make_debug_mesh(2, 2))
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    layer = {k: v[0] for k, v in params["layers"]["moe"]["router"].items()}
    experts = {k: {"w": v["w"][0]} for k, v in params["layers"]["moe"]["experts"].items()}
    x = torch.zeros(2, 4, cfg.d_model)
    with pspec.running(make_debug_mesh(1, 2), None, ()):
        with pytest.raises(ValueError, match="bound"):
            moe_ffn({"router": layer, "experts": experts}, cfg, x)
