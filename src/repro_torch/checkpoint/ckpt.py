"""npz checkpoints in the reference's format (``repro/checkpoint/ckpt.py``).

A checkpoint is one ``.npz`` whose keys are the '/'-joined paths of the
saved tree's leaves (``params/0/W``, ``params/layers/attn/wq/w``,
``opt/.mu/embed/table`` for a NamedTuple's field, ...) plus ``__step__``,
so either package reads what the other writes. numpy has no
bfloat16: the reference's ``np.asarray`` of a bf16 leaf is an ml_dtypes
array, which ``np.savez`` stores as 2-byte void (``|V2``) holding the bf16
bits. The port writes a bf16 tensor's bits the same way and reads a
``|V2`` leaf back as a ``torch.bfloat16`` tensor.
"""
from __future__ import annotations

import pathlib
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn


BF16_BITS = np.dtype("V2")


def array_of(t: Any) -> np.ndarray:
    """A leaf as numpy; a bf16 tensor as ``|V2`` holding its bits."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_BITS)
    return t.numpy()


def tensor_of(a: Any) -> torch.Tensor:
    """An array as a CPU tensor of its dtype; bfloat16 (``|V2`` bits, or an
    ml_dtypes ``bfloat16`` array) as ``torch.bfloat16``."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype == BF16_BITS or a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _children(tree: Any):
    """A container's ``(key, child)`` pairs, keyed as the reference's paths
    write them (a NamedTuple's field ``f`` as ``.f``, as jax's path key
    prints), or None for a leaf."""
    if isinstance(tree, (dict, nn.ParameterDict)):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat: Dict[str, Any] = {}
    for k, v in kids:
        flat.update(_leaves(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {k: array_of(v) for k, v in _leaves(tree).items()}


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree`` (nested dicts/lists/tuples/NamedTuples of tensors or
    arrays, or the port's parameter containers) and ``step`` to ``path``."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    flat["__step__"] = np.asarray(step)
    np.savez_compressed(p, **flat)


def _cast(a: np.ndarray, like: Any) -> Any:
    """``a`` as the template leaf ``like``: a tensor of its dtype on its
    device, or an array of its dtype."""
    if isinstance(like, torch.Tensor):
        return tensor_of(a).to(dtype=like.dtype, device=like.device)
    dtype = np.asarray(like).dtype
    if a.dtype == BF16_BITS:
        return tensor_of(a).to(torch.float32).numpy().astype(dtype)
    return np.asarray(a, dtype=dtype)


def _restore(tree: Any, flat: Dict[str, np.ndarray], prefix: str = "") -> Any:
    kids = _children(tree)
    if kids is None:
        return _cast(flat[prefix], tree)
    vals = [_restore(v, flat, f"{prefix}/{k}" if prefix else k) for k, v in kids]
    if isinstance(tree, (dict, nn.ParameterDict)):
        return {k: v for (k, _), v in zip(kids, vals)}
    if isinstance(tree, tuple):
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return vals


def load_checkpoint(path: str, template: Any = None) -> Tuple[Any, int]:
    """``(tree, step)`` of the checkpoint at ``path``.

    With a ``template`` (as the reference's): the template's tree of dicts,
    lists, tuples and NamedTuples, each leaf in the template leaf's dtype
    (and on its device, for a tensor); ``KeyError`` if the checkpoint lacks
    a leaf. Without one: ``{leaf path: array}``, a bf16 leaf (``|V2``) as a
    CPU ``torch.bfloat16`` tensor (:func:`unflatten` nests it)."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__step__"}
        step = int(data["__step__"])
    if template is None:
        return {k: tensor_of(a) if a.dtype == BF16_BITS else a for k, a in flat.items()}, step
    missing = [k for k in _leaves(template) if k not in flat]
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
    return _restore(template, flat), step


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """Nested dicts from '/'-joined leaf paths (``{"params": {"embed":
    {"table": ...}, ...}}``): the tree a dict-only checkpoint was saved from."""
    tree: Dict[str, Any] = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return tree
