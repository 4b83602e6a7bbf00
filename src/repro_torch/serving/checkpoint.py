"""Load serving bundles written by the reference (``repro.serving.save_bundle``).

A bundle is a directory holding ``params.npz`` (keys ``params/<layer>/<W|a1|a2>``
plus ``__step__``) and ``meta.json`` (the effective ``FedGATConfig`` under
``"model"``, the privacy config under ``"privacy"``, method, num_clients,
seed and step). The parameter structure is built from ``meta["model"]`` and
the serving graph's dimensions, and every stored array is checked against
it. ``meta["privacy"]`` stays a plain dict until privacy is ported; writing
bundles waits for the trainer.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, NamedTuple

from torch import nn

from repro_torch._device import DeviceLike
from repro_torch.checkpoint.ckpt import load_checkpoint
from repro_torch.core.fedgat_model import FedGATConfig, layer_shapes, params_from_numpy

PARAMS_NAME = "params.npz"
META_NAME = "meta.json"
BUNDLE_FORMAT = 1


class ServingCheckpoint(NamedTuple):
    params: nn.ModuleList
    model: FedGATConfig
    privacy: Dict[str, Any]
    meta: Dict[str, Any]


def load_bundle(path: str, graph: Any, *, device: DeviceLike = None) -> ServingCheckpoint:
    """Restore (params on ``device``, model config, privacy dict, meta).

    ``graph`` supplies the feature/class dimensions; a bundle whose arrays
    do not have the shapes those dimensions imply raises here rather than
    at the first query.
    """
    p = pathlib.Path(path)
    meta_path = p / META_NAME
    if not meta_path.exists():
        raise FileNotFoundError(f"not a serving bundle (no {META_NAME}): {p}")
    meta = json.loads(meta_path.read_text())
    if meta.get("format") != BUNDLE_FORMAT:
        raise ValueError(
            f"unsupported bundle format {meta.get('format')!r} "
            f"(this build reads format {BUNDLE_FORMAT})"
        )
    model_kw = dict(meta["model"])
    model_kw["domain"] = tuple(model_kw["domain"])
    model_cfg = FedGATConfig(**model_kw)

    flat, _step = load_checkpoint(str(p / PARAMS_NAME))
    layers = []
    for li, (heads, d_in, d_out) in enumerate(
        layer_shapes(graph.feature_dim, graph.num_classes, model_cfg)
    ):
        want = {"W": (heads, d_in, d_out), "a1": (heads, d_out), "a2": (heads, d_out)}
        layer = {}
        for name, shape in want.items():
            key = f"params/{li}/{name}"
            if key not in flat:
                raise KeyError(f"checkpoint missing key {key!r}")
            if tuple(flat[key].shape) != shape:
                raise ValueError(
                    f"checkpoint {key} has shape {tuple(flat[key].shape)}, the "
                    f"model config and graph dims imply {shape}"
                )
            layer[name] = flat[key]
        layers.append(layer)
    return ServingCheckpoint(
        params=params_from_numpy(layers, device=device),
        model=model_cfg,
        privacy=dict(meta.get("privacy") or {}),
        meta=meta,
    )
