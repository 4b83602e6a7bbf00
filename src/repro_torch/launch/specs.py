"""Shape-only stand-ins per (arch x input-shape) (the port of
``repro/launch/specs.py``): trees of ``meta`` tensors, which carry a shape
and a dtype and allocate nothing, where the reference has
``ShapeDtypeStruct``s. dbrx-132b's params and yi-6b's ``long_500k`` cache
are described, never allocated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, InputShape

META = torch.device("meta")


def cfg_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Shape-dependent config adjustment.

    The dense/moe/vlm/audio archs are full-attention models; their
    ``sliding_window`` field declares the LONG-CONTEXT VARIANT used only for
    long_500k. All other shapes run them unwindowed. Hybrid (hymba) keeps
    its native SWA everywhere; ssm has no window.
    """
    if cfg.family in ("hybrid", "ssm"):
        return cfg
    if shape.name == "long_500k":
        return cfg
    return dataclasses.replace(cfg, sliding_window=0)


def _dt(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """Model inputs for the given shape (tokens/labels/prefix/frames or
    decode token). Cache specs are built separately (they are step state)."""
    B, S = shape.global_batch, shape.seq_len
    cfg = cfg_for_shape(cfg, shape)
    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {"tokens": _sds((B, S), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _sds((B, S), torch.int32)
        if cfg.family == "vlm":
            specs["prefix"] = _sds((B, cfg.prefix_len, cfg.d_model), _dt(cfg))
        if cfg.is_encdec:
            specs["frames"] = _sds((B, S // cfg.encoder_ratio, cfg.d_model), _dt(cfg))
        return specs
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _sds((B, 1), torch.int32)}


def cache_specs(cfg: ArchConfig, shape: InputShape) -> Any:
    """The decode cache for this shape, on the meta device."""
    from repro_torch.models import build_model

    cfg = cfg_for_shape(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    enc_len = (S // cfg.encoder_ratio) if cfg.is_encdec else 0
    return build_model(cfg).init_cache(B, S, enc_len, device=META)


def prefill_cache_specs(cfg: ArchConfig, shape: InputShape) -> Any:
    """The cache ``make_prefill_step(cfg, cache_len=seq_len)`` returns for
    this shape's inputs (the reference takes it from ``eval_shape`` of the
    prefill): a decode cache over the prompt, a VLM's prefix included, and
    for an encoder-decoder the cache after its one decoder step."""
    from repro_torch.models import build_model

    cfg = cfg_for_shape(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    if cfg.is_encdec:
        return build_model(cfg).init_cache(B, S, S // cfg.encoder_ratio, device=META)
    prefix = cfg.prefix_len if cfg.family == "vlm" else 0
    return build_model(cfg).init_cache(B, S + prefix, 0, device=META)


def param_specs(cfg: ArchConfig, shape: InputShape) -> Any:
    """The parameter tree's shapes and dtypes: the ``init`` walk over the
    same ``Draw``/``Fill`` spec trees, on the meta device."""
    from repro_torch.models import build_model

    cfg = cfg_for_shape(cfg, shape)
    return build_model(cfg).init(torch.Generator(), device=META)
