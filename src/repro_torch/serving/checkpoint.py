"""Serving bundles in the reference's format (``repro/serving/checkpoint.py``).

A bundle is a directory holding ``params.npz`` (keys ``params/<layer>/<W|a1|a2>``
plus ``__step__``) and ``meta.json`` (the effective ``FedGATConfig`` under
``"model"``, the privacy config under ``"privacy"``, method, backend,
num_clients, beta, seed and step, and the run manifest under
``"manifest"``). :func:`save_bundle` writes one from a Trainer run,
readable by both packages' ``load_bundle``. :func:`load_bundle` builds
the parameter structure from ``meta["model"]`` and the serving graph's
dimensions and checks every stored array against it; ``meta["privacy"]``
stays a plain dict until privacy mechanisms are ported.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Dict, NamedTuple, Optional

from torch import nn

from repro_torch._device import DeviceLike
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.core.fedgat_model import FedGATConfig, layer_shapes, params_from_numpy
from repro_torch.telemetry.manifest import build_manifest

PARAMS_NAME = "params.npz"
META_NAME = "meta.json"
BUNDLE_FORMAT = 1


class ServingCheckpoint(NamedTuple):
    params: nn.ModuleList
    model: FedGATConfig
    privacy: Dict[str, Any]
    meta: Dict[str, Any]


def save_bundle(
    path: str,
    params: Any,
    fed_cfg: Any,
    *,
    step: int = 0,
    extra: Optional[Dict[str, Any]] = None,
) -> pathlib.Path:
    """Write a serving bundle for a Trainer run. ``fed_cfg`` is the
    :class:`~repro_torch.federated.trainer.FederatedConfig` the run trained
    under; the stored model config is the effective one
    (``method_model_config``), so a DistGAT bundle records the engine it
    used."""
    from repro_torch.federated.trainer import method_model_config

    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    save_checkpoint(str(p / PARAMS_NAME), {"params": params}, step=step)
    meta = {
        "format": BUNDLE_FORMAT,
        "method": fed_cfg.method,
        "backend": fed_cfg.backend,
        "num_clients": int(fed_cfg.num_clients),
        "beta": float(fed_cfg.beta),
        "seed": int(fed_cfg.seed),
        "step": int(step),
        "model": dataclasses.asdict(method_model_config(fed_cfg)),
        "privacy": dataclasses.asdict(fed_cfg.privacy),
        "manifest": build_manifest(cfg=fed_cfg),
    }
    if extra:
        meta.update(extra)
    (p / META_NAME).write_text(json.dumps(meta, indent=1, sort_keys=True))
    return p


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
