"""``load_checkpoint(path, template)`` against the reference's
(``src/repro/checkpoint/ckpt.py``): ``tests/test_substrate.py``'s cases
(the round trip into a template's tree, the ``KeyError`` on a missing
leaf) on checkpoints that either package wrote, the template's dtypes and
devices, bf16 leaves, NamedTuples keyed as jax keys them; and the call
forms the reference's callers use (``adam_init_f32(params_shape=...)``,
``launch.specs.INPUT_SHAPES``).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load_checkpoint
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.configs import get_config as j_get_config
from repro.launch import specs as j_specs
from repro.launch import steps as j_steps
from repro.models import build_model as j_build_model
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.ckpt import _leaves
from repro_torch.configs import get_config
from repro_torch.launch import specs, steps
from repro_torch.launch.steps import adam_init_f32
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamState

torch.set_num_threads(1)


def _tree():
    return {"layers": [{"w": torch.arange(6.0).reshape(2, 3)}, {"w": torch.ones(4)}],
            "scale": torch.tensor(2.5)}


def test_round_trip_into_the_template(tmp_path):
    """tests/test_substrate.py:96-106 on the port: the template's tree (a
    list stays a list, a tuple a tuple), its values, the step."""
    tree = _tree()
    tree["pair"] = (torch.zeros(2), torch.full((3,), 7.0))
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, tree, step=42)
    template = {"layers": [{"w": torch.zeros(2, 3)}, {"w": torch.zeros(4)}],
                "scale": torch.zeros(()), "pair": (torch.zeros(2), torch.zeros(3))}
    restored, step = load_checkpoint(path, template)
    assert step == 42
    assert isinstance(restored["layers"], list) and isinstance(restored["pair"], tuple)
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert torch.equal(a, b)


def test_missing_key_raises(tmp_path):
    """tests/test_substrate.py:109-113, with the reference's message."""
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"a": torch.zeros(3)}, step=0)
    with pytest.raises(KeyError, match=r"checkpoint missing keys: \['b'\]\.\.\."):
        load_checkpoint(path, {"a": torch.zeros(3), "b": torch.zeros(2)})
    jtemplate = {"a": jnp.zeros(3), "b": jnp.zeros(2)}
    with pytest.raises(KeyError) as want:
        j_load_checkpoint(path, jtemplate)
    with pytest.raises(KeyError) as got:
        load_checkpoint(path, {"a": torch.zeros(3), "b": torch.zeros(2)})
    assert str(got.value) == str(want.value)


def test_the_template_sets_dtype_and_device(tmp_path):
    """Each leaf comes back in the template leaf's dtype (a tensor on its
    device, an array as an array), as the reference's ``jnp.asarray(arr,
    dtype=leaf.dtype)``."""
    path = str(tmp_path / "c.npz")
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    j_save_checkpoint(path, {"x": jnp.asarray(x), "n": jnp.arange(4)}, step=3)
    template = {"x": torch.zeros(3, 5, dtype=torch.bfloat16, device="meta"),
                "n": np.zeros(4, np.float64)}
    restored, step = load_checkpoint(path, template)
    want, _ = j_load_checkpoint(path, {"x": jnp.zeros((3, 5), jnp.bfloat16),
                                       "n": jnp.zeros(4, jnp.float32)})
    assert step == 3
    assert restored["x"].dtype == torch.bfloat16 and restored["x"].device.type == "meta"
    assert isinstance(restored["n"], np.ndarray) and restored["n"].dtype == np.float64
    np.testing.assert_array_equal(restored["n"], np.asarray(want["n"]))
    on_cpu, _ = load_checkpoint(path, {"x": torch.zeros(3, 5, dtype=torch.bfloat16),
                                       "n": torch.zeros(4, dtype=torch.int32)})
    np.testing.assert_array_equal(on_cpu["x"].view(torch.int16).numpy(),
                                  np.asarray(want["x"]).view(np.int16))
    assert on_cpu["n"].dtype == torch.int32


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_bf16_params_and_adam_state_from_either_package(tmp_path, writer):
    """A bf16 model's params and its float32 Adam state (a NamedTuple, keyed
    ``.step``/``.mu``/``.nu`` as jax keys it), written by either package,
    restore into the port's template: its tree and dtypes, every leaf's bits
    those of the file (the reference's own loader cannot cast a ``|V2``
    leaf, so the file is read with numpy)."""
    jcfg = dataclasses.replace(j_get_config("yi-6b").reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(get_config("yi-6b").reduced(), dtype="bfloat16")
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    template_params = build_model(cfg).init(torch.Generator().manual_seed(1), "cpu")
    template = {"params": template_params, "opt": adam_init_f32(template_params)}
    path = str(tmp_path / "ckpt.npz")
    j_save_checkpoint(path, {"params": jparams, "opt": j_steps.adam_init_f32(jparams)}, step=5)
    if writer == "port":
        restored, _ = load_checkpoint(path, template)
        path = str(tmp_path / "port.npz")
        save_checkpoint(path, restored, step=5)
    restored, step = load_checkpoint(path, template)
    assert step == 5 and isinstance(restored["opt"], AdamState)
    want, kinds = _leaves(template), _leaves(restored)
    assert sorted(kinds) == sorted(want)
    with np.load(path) as data:
        assert sorted(data.files) == sorted([*want, "__step__"])
        for key, t in kinds.items():
            assert t.dtype == want[key].dtype and t.shape == want[key].shape, key
            if t.dtype == torch.bfloat16:
                assert np.array_equal(t.view(torch.int16).numpy(), data[key].view(np.int16)), key
            else:
                assert np.array_equal(t.numpy(), data[key]), key


def test_the_reference_restores_the_port_s_adam_state(tmp_path):
    """float32 params and their Adam state written by the port restore into
    the reference's template (its ``AdamState`` NamedTuple), leaf for leaf."""
    jcfg, cfg = j_get_config("rwkv6-1.6b").reduced(), get_config("rwkv6-1.6b").reduced()
    params = build_model(cfg).init(torch.Generator().manual_seed(1), "cpu")
    opt = adam_init_f32(params)
    opt = AdamState(step=torch.tensor(3, dtype=torch.int32),
                    mu=tree_map(lambda v: v + 1, opt.mu), nu=tree_map(lambda v: v + 2, opt.nu))
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, {"params": params, "opt": opt}, step=3)
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(0))
    restored, step = j_load_checkpoint(path, {"params": jparams,
                                              "opt": j_steps.adam_init_f32(jparams)})
    assert step == 3 and type(restored["opt"]).__name__ == "AdamState"
    got = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): np.asarray(v)
           for p, v in jax.tree_util.tree_flatten_with_path(restored)[0]}
    mine = _leaves({"params": params, "opt": opt})
    assert sorted(got) == sorted(mine)
    for k, t in mine.items():
        np.testing.assert_array_equal(got[k], t.numpy(), err_msg=k)


def test_flat_form_without_a_template(tmp_path):
    """No template: today's ``{leaf path: array}`` (what the serving
    bundle's loader reads), a bf16 leaf as a torch.bfloat16 tensor."""
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"params": [{"W": torch.ones(2, 2)}],
                           "b": torch.ones(3, dtype=torch.bfloat16)}, step=1)
    flat, step = load_checkpoint(path)
    assert step == 1 and sorted(flat) == ["b", "params/0/W"]
    assert isinstance(flat["params/0/W"], np.ndarray) and flat["b"].dtype == torch.bfloat16


def test_call_forms_are_the_reference_s():
    assert list(inspect.signature(adam_init_f32).parameters) == list(
        inspect.signature(j_steps.adam_init_f32).parameters) == ["params_shape"]
    params = {"w": torch.zeros(2, 3, dtype=torch.bfloat16)}
    st = adam_init_f32(params_shape=params)
    assert st.mu["w"].dtype == torch.float32 and st.step.dtype == torch.int32
    assert list(inspect.signature(load_checkpoint).parameters) == list(
        inspect.signature(j_load_checkpoint).parameters)
    assert set(specs.INPUT_SHAPES) == set(j_specs.INPUT_SHAPES)
    for name, shape in specs.INPUT_SHAPES.items():
        assert dataclasses.astuple(shape) == dataclasses.astuple(j_specs.INPUT_SHAPES[name])
    assert steps.adam_init_f32 is adam_init_f32
