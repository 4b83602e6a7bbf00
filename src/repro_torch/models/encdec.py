"""Encoder-decoder backbone (SeamlessM4T-v2 assigned config,
arXiv:2308.11596), the port of ``repro/models/encdec.py``.

The speech frontend is stubbed: ``frames`` are pre-extracted frame
embeddings (B, S_enc, d_model). The transformer backbone:

  encoder: bidirectional self-attention + SwiGLU blocks
  decoder: causal self-attention + cross-attention + SwiGLU blocks

Decode uses a self-attention KV cache plus per-layer static cross K/V
computed once from the encoder memory.

Tensor parallel (``layers.Region``): the encoder layers, the decoder's
self- and cross-attention and the MLPs compute with the rank's blocks as in
``models.transformer``; the cross K/V of the KV heads the rank reads (or,
for a cache, of ``wk``'s block), the memory entering each layer's region.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (
    KVCache,
    attention_decode,
    attention_full,
    cross_kv,
    init_attention,
    init_kv_cache,
)
from repro_torch.models.layers import (
    embed,
    init_embedding,
    init_rmsnorm,
    materialize,
    rmsnorm,
    swiglu,
    swiglu_init,
    unembed,
)
from repro_torch.models.transformer import (
    _dtype,
    _stacked,
    next_token_ce,
    stack,
    unstack,
    unstack_state,
)


def init_encoder_layer(cfg: ArchConfig) -> Dict:
    return {
        "ln1": init_rmsnorm(cfg.d_model),
        "attn": init_attention(cfg),
        "ln2": init_rmsnorm(cfg.d_model),
        "mlp": swiglu_init(cfg.d_model, cfg.d_ff),
    }


def init_decoder_layer(cfg: ArchConfig) -> Dict:
    return {
        "ln1": init_rmsnorm(cfg.d_model),
        "self_attn": init_attention(cfg),
        "ln2": init_rmsnorm(cfg.d_model),
        "cross_attn": init_attention(cfg),
        "ln3": init_rmsnorm(cfg.d_model),
        "mlp": swiglu_init(cfg.d_model, cfg.d_ff),
    }


def init_encdec(generator: torch.Generator, cfg: ArchConfig, device: torch.device) -> Dict:
    dt = _dtype(cfg)

    def make(spec, lead=()):
        return materialize(spec, generator, dt, device, lead)

    return {
        "embed": make(init_embedding(cfg.padded_vocab(), cfg.d_model)),
        "enc_layers": make(init_encoder_layer(cfg), (cfg.encoder_layers,)),
        "dec_layers": make(init_decoder_layer(cfg), (cfg.num_layers,)),
        "enc_norm": make(init_rmsnorm(cfg.d_model)),
        "final_norm": make(init_rmsnorm(cfg.d_model)),
        "head": make(init_embedding(cfg.padded_vocab(), cfg.d_model)),
    }


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


def _run(body, x, lp, remat: bool):
    if remat:
        return checkpoint(body, x, lp, use_reentrant=False, preserve_rng_state=False)
    return body(x, lp)


def encode(params: Dict, cfg: ArchConfig, frames: torch.Tensor, *, coeffs=None,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, d_model) stub embeddings -> encoder memory."""
    B, S, _ = frames.shape
    positions = _positions(B, S, frames.device)

    def body(x, lp):
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        out, _ = attention_full(lp["attn"], cfg, h, positions, causal=False, coeffs=coeffs)
        x = x + out
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        return x + swiglu(lp["mlp"], h2, cfg.d_ff)

    x = frames.to(_dtype(cfg))
    for lp in unstack(params["enc_layers"], cfg.encoder_layers):
        x = _run(body, x, lp, remat)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def decode_train(
    params: Dict, cfg: ArchConfig, tokens: torch.Tensor, memory: torch.Tensor, *,
    coeffs=None, remat: bool = False,
) -> torch.Tensor:
    """Teacher-forced decoder -> logits (B, S_dec, V)."""
    B, S = tokens.shape
    positions = _positions(B, S, tokens.device)
    mem_pos = _positions(B, memory.shape[1], tokens.device)
    x = embed(params["embed"], tokens, cfg.padded_vocab())

    def body(x, lp):
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        out, _ = attention_full(lp["self_attn"], cfg, h, positions, coeffs=coeffs)
        x = x + out
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        mk, mv = cross_kv(lp["cross_attn"], cfg, memory)
        out, _ = attention_full(
            lp["cross_attn"], cfg, h2, positions, causal=False,
            coeffs=coeffs, kv_override=(mk, mv, mem_pos),
        )
        x = x + out
        h3 = rmsnorm(lp["ln3"], x, cfg.norm_eps)
        return x + swiglu(lp["mlp"], h3, cfg.d_ff)

    for lp in unstack(params["dec_layers"], cfg.num_layers):
        x = _run(body, x, lp, remat)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["head"], x, cfg.padded_vocab()).to(torch.float32)


def encdec_loss(
    params: Dict, cfg: ArchConfig, frames: torch.Tensor, tokens: torch.Tensor,
    labels: torch.Tensor, *, coeffs=None, remat: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    memory = encode(params, cfg, frames, coeffs=coeffs, remat=remat)
    logits = decode_train(params, cfg, tokens, memory, coeffs=coeffs, remat=remat)
    ce = next_token_ce(logits, labels, cfg.padded_vocab())
    return ce, {"ce": ce}


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------

class EncDecCache(NamedTuple):
    self_kv: KVCache         # stacked KVCache over decoder layers
    cross_kv: KVCache        # stacked static KVCache (pos >= 0 everywhere)
    pos: torch.Tensor


def init_encdec_cache(cfg: ArchConfig, batch: int, cache_len: int, enc_len: int,
                      device: torch.device, kv_heads: int = None) -> EncDecCache:
    """An empty cache of ``kv_heads`` KV heads (default: all of them)."""
    dt = _dtype(cfg)
    L = cfg.num_layers
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    kv_heads = kv_heads or cfg.num_kv_heads
    shape = (batch, enc_len, kv_heads, cfg.resolved_head_dim)

    def cross():
        return KVCache(
            k=torch.zeros(shape, dtype=dt, device=device),
            v=torch.zeros(shape, dtype=dt, device=device),
            pos=torch.zeros((batch, enc_len), dtype=torch.int32, device=device),
        )

    return EncDecCache(
        self_kv=_stacked(lambda: init_kv_cache(cfg, batch, W, dt, device, kv_heads), L),
        cross_kv=_stacked(cross, L),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def build_cross_cache(params: Dict, cfg: ArchConfig, memory: torch.Tensor) -> KVCache:
    """Precompute per-decoder-layer cross K/V from encoder memory (of the KV
    heads of ``wk``'s block)."""
    B, Sm, _ = memory.shape
    pos = _positions(B, Sm, memory.device).contiguous()
    per_layer = []
    for lp in unstack(params["dec_layers"], cfg.num_layers):
        mk, mv = cross_kv(lp["cross_attn"], cfg, memory, for_cache=True)
        per_layer.append(KVCache(k=mk, v=mv, pos=pos))
    return stack(per_layer)


def encdec_decode_step(
    params: Dict, cfg: ArchConfig, cache: EncDecCache, token: torch.Tensor, *, coeffs=None,
) -> Tuple[torch.Tensor, EncDecCache]:
    x = embed(params["embed"], token, cfg.padded_vocab())
    pos = cache.pos
    L = cfg.num_layers
    new_self = []
    for lp, skv, ckv in zip(unstack(params["dec_layers"], L),
                            unstack_state(cache.self_kv, L), unstack_state(cache.cross_kv, L)):
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        out, skv = attention_decode(lp["self_attn"], cfg, h, pos, skv, coeffs=coeffs)
        new_self.append(skv)
        x = x + out
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        out, _ = attention_decode(
            lp["cross_attn"], cfg, h2, pos, ckv, coeffs=coeffs, cross=True
        )
        x = x + out
        h3 = rmsnorm(lp["ln3"], x, cfg.norm_eps)
        x = x + swiglu(lp["mlp"], h3, cfg.d_ff)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params["head"], x, cfg.padded_vocab()).to(torch.float32)
    return logits, EncDecCache(self_kv=stack(new_self), cross_kv=cache.cross_kv, pos=pos + 1)
