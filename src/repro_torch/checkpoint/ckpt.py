"""npz checkpoints in the reference's format (``repro/checkpoint/ckpt.py``).

A checkpoint is one ``.npz`` whose keys are the '/'-joined paths of the
saved tree's leaves (``params/0/W``, ...) plus ``__step__``, so either
package reads what the other writes.
"""
from __future__ import annotations

import pathlib
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    if isinstance(tree, (dict, nn.ParameterDict)):
        items = tree.items()
    elif isinstance(tree, (list, tuple, nn.ModuleList)):
        items = enumerate(tree)
    else:
        t = tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree
        return {prefix: np.asarray(t)}
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


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """``({leaf path: array}, step)`` of the checkpoint at ``path``."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__step__"}
        step = int(data["__step__"])
    return flat, step
