"""Model zoo: one uniform functional interface over all assigned families
(the port of ``repro/models/zoo.py``), and the carry of the reference's
parameter trees into the port."""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import tree_map
from repro_torch.checkpoint.ckpt import tensor_of
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as ed
from repro_torch.models import transformer as tf


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable[..., Dict]                        # (generator, device=None)
    loss: Callable[..., Tuple[torch.Tensor, Dict]]   # (params, batch)
    prefill: Callable[..., Tuple[torch.Tensor, Any]]  # (params, batch)
    decode_step: Callable[..., Tuple[torch.Tensor, Any]]  # (params, cache, token)
    init_cache: Callable[..., Any]                   # (batch, cache_len, enc_len, device=None)


def build_model(cfg: ArchConfig) -> Model:
    """The reference's ``build_model``. ``init(generator, device=None)``
    draws params from an explicit ``torch.Generator`` onto ``device``
    (default: the CUDA device; raises without one unless given the CPU)."""
    coeffs = tf.cheb_coeffs(cfg)

    if cfg.is_encdec:
        def init(generator, device: DeviceLike = None):
            return ed.init_encdec(generator, cfg, resolve_device(device))

        def loss(params, batch):
            return ed.encdec_loss(
                params, cfg, batch["frames"], batch["tokens"], batch["labels"],
                coeffs=coeffs,
            )

        def prefill(params, batch):
            memory = ed.encode(params, cfg, batch["frames"], coeffs=coeffs)
            cross = ed.build_cross_cache(params, cfg, memory)
            B = batch["tokens"].shape[0]
            cache = ed.init_encdec_cache(
                cfg, B, batch["cache_len"], memory.shape[1], memory.device
            )._replace(cross_kv=cross)
            # the decoder prompt is a single BOS handled by decode_step
            return ed.encdec_decode_step(
                params, cfg, cache, batch["tokens"][:, :1], coeffs=coeffs
            )

        def decode_step(params, cache, token):
            return ed.encdec_decode_step(params, cfg, cache, token, coeffs=coeffs)

        def init_cache(batch, cache_len, enc_len=0, device: DeviceLike = None):
            return ed.init_encdec_cache(cfg, batch, cache_len, enc_len, resolve_device(device))

        return Model(cfg, init, loss, prefill, decode_step, init_cache)

    def init(generator, device: DeviceLike = None):
        return tf.init_lm(generator, cfg, resolve_device(device))

    def loss(params, batch):
        return tf.lm_loss(
            params, cfg, batch["tokens"], batch["labels"],
            prefix=batch.get("prefix"), coeffs=coeffs,
        )

    def prefill(params, batch):
        return tf.lm_prefill(
            params, cfg, batch["tokens"], prefix=batch.get("prefix"),
            coeffs=coeffs, cache_len=batch.get("cache_len"),
        )

    def decode_step(params, cache, token):
        return tf.lm_decode_step(params, cfg, cache, token, coeffs=coeffs)

    def init_cache(batch, cache_len, enc_len=0, device: DeviceLike = None):
        return tf.init_decode_cache(cfg, batch, cache_len, resolve_device(device))

    return Model(cfg, init, loss, prefill, decode_step, init_cache)


def params_from_numpy(tree: Any, *, device: DeviceLike = None) -> Any:
    """The reference's ``init_lm``/``init_encdec`` tree (numpy arrays, or
    anything ``np.asarray`` reads, or tensors) as the port's params on
    ``device``: key paths, stacked axes and dtypes kept (a bf16 leaf,
    ml_dtypes or ``|V2`` from an npz, through its bits)."""
    dev = resolve_device(device)
    return tree_map(lambda a: tensor_of(a).to(dev), tree)
