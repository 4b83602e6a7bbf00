"""Unified decoder-only LM covering the dense / moe / ssm / hybrid / vlm
families (the port of ``repro/models/transformer.py``).

Per-layer parameters are stacked on a leading L axis, the layout of the
reference's ``vmap``-initialised, ``lax.scan``-consumed trees, so key paths,
shapes and checkpoints are the reference's. The backbone loops over l in
Python (``unbind`` once, so the backward stacks the L gradients once);
``remat=True`` recomputes each layer in the backward
(``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``).

Layer bodies by family:
  dense | vlm : pre-norm GQA attention + SwiGLU
  moe         : pre-norm GQA attention + token-choice top-k MoE
  hybrid      : Hymba parallel (attention || mamba) + SwiGLU
  ssm         : RWKV-6 time-mix + channel-mix (attention-free)

The same stacked-parameter layout serves three entry points:
  lm_loss        — next-token CE (+ MoE aux) for the train step
  lm_prefill     — forward returning per-layer decode caches
  lm_decode_step — single-token step returning new caches
"""
from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._tree import tree_leaves, tree_unflatten
from repro_torch.configs.base import ArchConfig
from repro_torch.core.chebyshev import attention_series
from repro_torch.launch import pspec
from repro_torch.models import hybrid as hyb
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models.attention import (
    KVCache,
    attention_decode,
    attention_full,
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
from repro_torch.models.moe import init_moe, moe_ffn

MOE_AUX_COEF = 0.01


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def cheb_coeffs(cfg: ArchConfig) -> Optional[np.ndarray]:
    if cfg.attention_variant != "chebyshev":
        return None
    q = attention_series(cfg.cheb_degree, (-cfg.cheb_domain, cfg.cheb_domain), basis="power")
    return np.asarray(q, np.float32)


# ---------------------------------------------------------------------------
# Stacked trees
# ---------------------------------------------------------------------------

def unstack(tree: Any, n: int) -> List[Any]:
    """The n slices along the leading axis of every leaf, as n trees of
    views (one ``unbind`` a leaf: its backward stacks the slices' grads)."""
    leaves = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    return [tree_unflatten(tree, [s[i] for s in leaves]) for i in range(n)]


def stack(trees: List[Any]) -> Any:
    """Trees of one structure (tensors, tuples, NamedTuples) stacked leaf by
    leaf on a new leading axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, tuple):
        parts = [stack(list(xs)) for xs in zip(*trees)]
        return type(first)(*parts) if hasattr(first, "_fields") else tuple(parts)
    raise TypeError(type(first))


def unstack_state(state: Any, n: int) -> List[Any]:
    """A stacked NamedTuple state (KVCache, RWKVState, MambaState) as n
    per-layer ones."""
    parts = [f.unbind(0) for f in state]
    return [type(state)(*(p[i] for p in parts)) for i in range(n)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_layer(cfg: ArchConfig) -> Dict:
    """One layer's spec tree (see ``layers.materialize``)."""
    if cfg.family == "ssm":
        return rwkv_mod.init_rwkv_layer(cfg)
    p: Dict[str, Any] = {
        "ln1": init_rmsnorm(cfg.d_model),
        "ln2": init_rmsnorm(cfg.d_model),
    }
    if cfg.family == "hybrid":
        p["hymba"] = hyb.init_hymba_block(cfg)
        p["mlp"] = swiglu_init(cfg.d_model, cfg.d_ff)
    elif cfg.family == "moe":
        p["attn"] = init_attention(cfg)
        p["moe"] = init_moe(cfg)
    else:  # dense | vlm
        p["attn"] = init_attention(cfg)
        p["mlp"] = swiglu_init(cfg.d_model, cfg.d_ff)
    return p


def init_lm(generator: torch.Generator, cfg: ArchConfig, device: torch.device) -> Dict:
    """Random params on ``device`` in the config's dtype, drawn from
    ``generator`` (on its own device) one layer slice at a time."""
    dt = _dtype(cfg)

    def make(spec, lead=()):
        return materialize(spec, generator, dt, device, lead)

    params = {
        "embed": make(init_embedding(cfg.padded_vocab(), cfg.d_model)),
        "layers": make(init_layer(cfg), (cfg.num_layers,)),
        "final_norm": make(init_rmsnorm(cfg.d_model)),
    }
    if not cfg.tie_embeddings:
        params["head"] = make(init_embedding(cfg.padded_vocab(), cfg.d_model))
    return params


# ---------------------------------------------------------------------------
# Full-sequence forward (train / prefill)
# ---------------------------------------------------------------------------

def _layer_seq(
    lp: Dict, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, coeffs,
    collect_cache: bool,
):
    """One layer over the full sequence. Returns (x, cache_ys, moe_aux)."""
    B = x.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        st0 = rwkv_mod.init_rwkv_state(cfg, B, x.dtype, x.device)
        x, st = rwkv_mod.rwkv_layer_seq(lp, cfg, x, st0, cfg.norm_eps)
        return x, (st if collect_cache else None), zero
    if cfg.family == "hybrid":
        st0 = hyb.init_mamba_state(cfg, B, x.dtype, x.device)
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        out, k, v, st = hyb.hymba_block_seq(lp["hymba"], cfg, h, positions, st0, coeffs)
        x = x + out
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        x = x + swiglu(lp["mlp"], h2)
        return x, ((k, v, st) if collect_cache else None), zero
    # dense / vlm / moe
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    out, (k, v) = attention_full(lp["attn"], cfg, h, positions, coeffs=coeffs)
    x = x + out
    h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    if cfg.family == "moe":
        ffn_out, aux = moe_ffn(lp["moe"], cfg, h2)
        x = x + ffn_out
        extra = aux["moe_aux_loss"]
    else:
        x = x + swiglu(lp["mlp"], h2)
        extra = zero
    return x, ((k, v) if collect_cache else None), extra


def lm_backbone(
    params: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    coeffs=None,
    collect_cache: bool = False,
    remat: bool = False,
) -> Tuple[torch.Tensor, Any, torch.Tensor]:
    """Embedded input -> final hidden. Returns (x, per-layer ys stacked on
    a leading L axis or None, moe_aux)."""
    caches, extras = [], []
    for lp in unstack(params["layers"], cfg.num_layers):
        def body(x, lp=lp):
            return _layer_seq(lp, cfg, x, positions, coeffs, collect_cache)

        if remat:
            x, ys, extra = checkpoint(body, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, ys, extra = body(x)
        caches.append(ys)
        extras.append(extra)
    return x, (stack(caches) if collect_cache else None), torch.sum(torch.stack(extras))


def lm_logits(params: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["head"]
    return unembed(table, x).to(torch.float32)


def lm_forward(
    params: Dict,
    cfg: ArchConfig,
    tokens: torch.Tensor,
    *,
    prefix: Optional[torch.Tensor] = None,
    coeffs=None,
    collect_cache: bool = False,
    remat: bool = False,
):
    """tokens (B, S); prefix (B, P, d) patch/frame embeddings for vlm."""
    x = embed(params["embed"], tokens)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    x, caches, aux = lm_backbone(
        params, cfg, x, positions,
        coeffs=coeffs, collect_cache=collect_cache, remat=remat,
    )
    return lm_logits(params, cfg, x), caches, aux


def next_token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over positions with ``labels >= 0``, over the
    whole batch when a sharded step splits its rows over ranks."""
    mask = (labels >= 0).to(torch.float32)
    logp = F.log_softmax(logits, dim=-1)
    tgt = torch.take_along_dim(logp, torch.clamp(labels, min=0).long()[..., None], dim=-1)[..., 0]
    num, den = torch.sum(tgt * mask), torch.sum(mask)
    bm, axes = pspec.split()
    if bm is not None and axes:
        num, den = bm.psum(num, axes), bm.all_reduce(den, axes)
    return -num / torch.clamp(den, min=1.0)


def lm_loss(
    params: Dict,
    cfg: ArchConfig,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    *,
    prefix: Optional[torch.Tensor] = None,
    coeffs=None,
    remat: bool = True,
) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy; loss only over text positions (labels < 0
    are masked, and VLM prefix positions carry no loss by construction)."""
    logits, _, aux = lm_forward(
        params, cfg, tokens, prefix=prefix, coeffs=coeffs, remat=remat
    )
    if prefix is not None:
        logits = logits[:, prefix.shape[1]:, :]
    ce = next_token_ce(logits, labels)
    total = ce + MOE_AUX_COEF * aux
    return total, {"ce": ce, "moe_aux": aux}


class DecodeCache(NamedTuple):
    kv: Optional[KVCache]     # stacked KVCache (leading layer axis), None for ssm
    ssm: Any                  # stacked RWKVState / MambaState, or None
    pos: torch.Tensor         # 0-d int32 — next absolute position


def lm_prefill(
    params: Dict,
    cfg: ArchConfig,
    tokens: torch.Tensor,
    *,
    prefix: Optional[torch.Tensor] = None,
    coeffs=None,
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, DecodeCache]:
    """Forward over the prompt, returning last-position logits + decode cache.

    With a sliding window the cache keeps only the last W positions
    (circular layout consistent with lm_decode_step's ``pos % W`` writes).
    """
    logits, caches, _ = lm_forward(
        params, cfg, tokens, prefix=prefix, coeffs=coeffs, collect_cache=True
    )
    B = tokens.shape[0]
    S = tokens.shape[1] + (prefix.shape[1] if prefix is not None else 0)
    dev = logits.device
    pos_next = torch.tensor(S, dtype=torch.int32, device=dev)

    def window(arr):
        """Keep last W positions, placed at slots pos % W (axis 2 = seq)."""
        W = cfg.sliding_window
        if not W or S <= W:
            return arr
        tail = arr[:, :, S - W:]
        # roll so that absolute position p sits at slot p % W
        return torch.roll(tail, (S - W) % W, dims=2)

    if cfg.family == "ssm":
        return logits[:, -1:, :], DecodeCache(kv=None, ssm=caches, pos=pos_next)

    if cfg.family == "hybrid":
        k, v, ssm = caches
    else:
        (k, v), ssm = caches, None
    # k/v: (L, B, S, KV, hd)
    pos = torch.arange(S, dtype=torch.int32, device=dev)[None, None].expand(cfg.num_layers, B, S)
    k, v, pos = window(k), window(v), window(pos)
    # Grow the cache to cache_len so decode steps have free slots
    # (slot layout must stay pos % W-consistent, so pad only when not rolled).
    W_now = k.shape[2]
    target = cache_len or (S + 128)
    if cfg.sliding_window:
        target = min(target, cfg.sliding_window)
    if target > W_now:
        padn = target - W_now
        padk = torch.zeros(k.shape[:2] + (padn,) + k.shape[3:], dtype=k.dtype, device=dev)
        k = torch.cat([k, padk], dim=2)
        v = torch.cat([v, padk.to(v.dtype)], dim=2)
        pos = torch.cat(
            [pos, torch.full(pos.shape[:2] + (padn,), -1, dtype=torch.int32, device=dev)], dim=2
        )
    kv = KVCache(k=k, v=v, pos=pos.contiguous())
    return logits[:, -1:, :], DecodeCache(kv=kv, ssm=ssm, pos=pos_next)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _stacked(make, n: int):
    """A per-layer NamedTuple state made n times and stacked."""
    return stack([make() for _ in range(n)])


def init_decode_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      device: torch.device) -> DecodeCache:
    dt = _dtype(cfg)
    L = cfg.num_layers
    pos = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.family == "ssm":
        ssm = _stacked(lambda: rwkv_mod.init_rwkv_state(cfg, batch, dt, device), L)
        return DecodeCache(kv=None, ssm=ssm, pos=pos)
    W = min(cache_len, cfg.sliding_window) if cfg.sliding_window else cache_len
    kv = _stacked(lambda: init_kv_cache(cfg, batch, W, dt, device), L)
    ssm = None
    if cfg.family == "hybrid":
        ssm = _stacked(lambda: hyb.init_mamba_state(cfg, batch, dt, device), L)
    return DecodeCache(kv=kv, ssm=ssm, pos=pos)


def lm_decode_step(
    params: Dict,
    cfg: ArchConfig,
    cache: DecodeCache,
    token: torch.Tensor,
    *,
    coeffs=None,
) -> Tuple[torch.Tensor, DecodeCache]:
    """token: (B, 1) -> (logits (B, 1, V), new cache)."""
    x = embed(params["embed"], token)
    pos = cache.pos
    L = cfg.num_layers
    layers = unstack(params["layers"], L)
    kvs = unstack_state(cache.kv, L) if cache.kv is not None else [None] * L
    ssms = unstack_state(cache.ssm, L) if cache.ssm is not None else [None] * L
    new_kv, new_ssm = [], []
    for lp, kv, st in zip(layers, kvs, ssms):
        if cfg.family == "ssm":
            x2, st = rwkv_mod.rwkv_layer_step(lp, cfg, x[:, 0, :], st, cfg.norm_eps)
            x = x2[:, None, :]
            new_ssm.append(st)
            continue
        h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
        if cfg.family == "hybrid":
            out, kv, st = hyb.hymba_block_step(lp["hymba"], cfg, h, pos, kv, st, coeffs)
            new_ssm.append(st)
        else:
            out, kv = attention_decode(lp["attn"], cfg, h, pos, kv, coeffs=coeffs)
        new_kv.append(kv)
        x = x + out
        h2 = rmsnorm(lp["ln2"], x, cfg.norm_eps)
        if cfg.family == "moe":
            ffn_out, _ = moe_ffn(lp["moe"], cfg, h2)
            x = x + ffn_out
        else:
            x = x + swiglu(lp["mlp"], h2)
    new_cache = DecodeCache(
        kv=stack(new_kv) if new_kv else None,
        ssm=stack(new_ssm) if new_ssm else None,
        pos=pos + 1,
    )
    return lm_logits(params, cfg, x), new_cache
