"""npz checkpoints in the reference's format (``repro/checkpoint/ckpt.py``).

A checkpoint is one ``.npz`` whose keys are the '/'-joined paths of the
saved tree's leaves (``params/0/W``, ``params/layers/attn/wq/w``, ...) plus
``__step__``, so either package reads what the other writes. numpy has no
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


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, (dict, nn.ParameterDict)):
        items = tree.items()
    elif isinstance(tree, (list, tuple, nn.ModuleList)):
        items = enumerate(tree)
    else:
        return {prefix: array_of(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree`` (nested dicts/lists of tensors or arrays, or the
    port's parameter containers) and ``step`` to ``path``."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)
    flat["__step__"] = np.asarray(step)
    np.savez_compressed(p, **flat)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], int]:
    """``({leaf path: array}, step)`` of the checkpoint at ``path``; a bf16
    leaf (``|V2``) comes back as a CPU ``torch.bfloat16`` tensor."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__step__"}
        step = int(data["__step__"])
    return {k: tensor_of(a) if a.dtype == BF16_BITS else a for k, a in flat.items()}, step


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
