"""GQA attention: the query-chunked full-sequence path and the KV-cache
decode (the port of ``repro/models/attention.py``).

Supports:
* grouped-query attention (num_kv_heads <= num_heads), optional QKV bias;
* RoPE "standard" / ChatGLM "2d" / "none";
* causal, prefix-LM (bidirectional prefix, PaliGemma) and sliding-window
  masking, with ``pos = -1`` marking empty cache slots;
* ``attention_variant="chebyshev"``: additive per-pair scores
  s_ij = a1.q_i + a2.k_j whose exp(psi(.)) is evaluated by the truncated
  power series instead of softmax's exp (the FedGAT technique mapped to
  transformers).

Both variants compute in plain PyTorch, as the reference computes them in
jnp (no Pallas kernel runs on this path). The full-sequence path loops over
query chunks of 512 (one chunk when S is not a multiple), which bounds the
score buffer at (B, H, 512, S).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.chebyshev import eval_power_series
from repro_torch.models.layers import Draw, apply_rope, dense, init_dense

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor       # (B, W, KV, hd)  — RoPE already applied at write time
    v: torch.Tensor       # (B, W, KV, hd)
    pos: torch.Tensor     # (B, W) int32 absolute positions, -1 = empty


def init_attention(cfg: ArchConfig) -> Dict:
    hd = cfg.resolved_head_dim
    p = {
        "wq": init_dense(cfg.d_model, cfg.num_heads * hd, cfg.qkv_bias),
        "wk": init_dense(cfg.d_model, cfg.num_kv_heads * hd, cfg.qkv_bias),
        "wv": init_dense(cfg.d_model, cfg.num_kv_heads * hd, cfg.qkv_bias),
        "wo": init_dense(cfg.num_heads * hd, cfg.d_model),
    }
    if cfg.attention_variant == "chebyshev":
        p["a1"] = Draw((cfg.num_heads, hd), hd ** -0.5)
        p["a2"] = Draw((cfg.num_heads, hd), hd ** -0.5)
    return p


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, cfg: ArchConfig, causal: bool) -> torch.Tensor:
    """(..., Sq, Sk) boolean allow-mask from absolute positions.

    k_pos = -1 marks empty cache slots. Prefix positions (< prefix_len) are
    mutually visible in prefix-LM mode (cfg.prefix_len > 0).
    """
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    ok = k >= 0
    if causal:
        vis = k <= q
        if cfg.prefix_len:
            vis = vis | (k < cfg.prefix_len)
        ok = ok & vis
    if cfg.sliding_window:
        ok = ok & (k > q - cfg.sliding_window)
    return ok


def _weights(scores: torch.Tensor, allow: torch.Tensor, variant: str, coeffs) -> torch.Tensor:
    """scores (..., Sq, Sk) -> attention weights, rows summing to 1."""
    if variant == "softmax":
        s = torch.where(allow, scores, NEG_INF)
        return torch.softmax(s.to(torch.float32), dim=-1)
    if variant == "chebyshev":
        # FedGAT-style polynomial score: weights = series(x) / sum series(x).
        x = torch.clamp(scores.to(torch.float32), -4.0, 4.0)
        e = eval_power_series(coeffs, x) * allow.to(torch.float32)
        return e / torch.clamp(torch.sum(e, dim=-1, keepdim=True), min=1e-9)
    raise ValueError(variant)


def _scores_and_weights(
    q: torch.Tensor, k: torch.Tensor, allow: torch.Tensor, p: Dict, cfg: ArchConfig, coeffs
) -> torch.Tensor:
    """Returns attention weights (B, H, Sq, Sk)."""
    hd = cfg.resolved_head_dim
    groups = cfg.num_heads // cfg.num_kv_heads
    qg = q.reshape(q.shape[0], q.shape[1], cfg.num_kv_heads, groups, hd)
    if cfg.attention_variant == "chebyshev":
        a1 = p["a1"].reshape(cfg.num_kv_heads, groups, hd).to(torch.float32)
        a2 = p["a2"].reshape(cfg.num_kv_heads, groups, hd).to(torch.float32)
        sq = torch.einsum("bsvgh,vgh->bvgs", qg.to(torch.float32), a1)
        sk = torch.einsum("btvh,vgh->bvgt", k.to(torch.float32), a2)
        scores = sq[..., :, None] + sk[..., None, :]             # (B,KV,G,Sq,Sk)
    else:
        scores = torch.einsum("bsvgh,btvh->bvgst", qg, k) * (hd ** -0.5)
    B, KV, G, Sq, Sk = scores.shape
    scores = scores.reshape(B, KV * G, Sq, Sk)
    return _weights(scores, allow[:, None], cfg.attention_variant, coeffs)


def _wv(weights: torch.Tensor, v: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """weights (B, H, Sq, Sk), v (B, Sk, KV, hd) -> (B, Sq, H*hd)."""
    hd = cfg.resolved_head_dim
    groups = cfg.num_heads // cfg.num_kv_heads
    B, H, Sq, Sk = weights.shape
    wg = weights.reshape(B, cfg.num_kv_heads, groups, Sq, Sk)
    out = torch.einsum("bvgst,btvh->bsvgh", wg.to(v.dtype), v)
    return out.reshape(B, Sq, H * hd)


def attention_full(
    p: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    coeffs=None,
    q_chunk: int = 512,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention. x: (B, S, d), positions: (B, S).

    Returns (out (B, S, d), (k, v)) — k/v already roped, for cache building.
    ``kv_override`` supplies external keys/values (cross-attention):
    (k, v, k_positions).
    """
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = _split_heads(dense(p["wq"], x), cfg.num_heads, hd)
    q = apply_rope(q, positions, mode=cfg.rope)
    if kv_override is None:
        k = _split_heads(dense(p["wk"], x), cfg.num_kv_heads, hd)
        v = _split_heads(dense(p["wv"], x), cfg.num_kv_heads, hd)
        k = apply_rope(k, positions, mode=cfg.rope)
        k_pos = positions
    else:
        k, v, k_pos = kv_override

    n_chunks = max(S // q_chunk, 1)
    if S % q_chunk != 0:
        n_chunks, q_chunk = 1, S  # fallback: single chunk

    outs = []
    for idx in range(n_chunks):
        rows = slice(idx * q_chunk, (idx + 1) * q_chunk)
        allow = _mask(positions[:, rows], k_pos, cfg, causal)      # (B, Cq, Sk)
        w = _scores_and_weights(q[:, rows], k, allow, p, cfg, coeffs)
        outs.append(_wv(w, v, cfg))
    out = outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)
    return dense(p["wo"], out), (k, v)


def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype: torch.dtype,
                  device: torch.device) -> KVCache:
    hd = cfg.resolved_head_dim
    shape = (batch, cache_len, cfg.num_kv_heads, hd)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    )


def attention_decode(
    p: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    pos: torch.Tensor,
    cache: KVCache,
    *,
    coeffs=None,
    cross: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, d); pos: 0-d int32 absolute position.

    Self-attention writes the new K/V into slot ``pos % W`` (circular buffer:
    sliding-window archs keep only the last W positions). Cross-attention
    (cross=True) attends to a static cache. The cache is not written in
    place: the new one is returned.
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    q = _split_heads(dense(p["wq"], x), cfg.num_heads, hd)
    qpos = pos.reshape(1, 1).expand(B, 1).to(torch.int32)
    q = apply_rope(q, qpos, mode=cfg.rope)

    if not cross:
        k_new = _split_heads(dense(p["wk"], x), cfg.num_kv_heads, hd)
        v_new = _split_heads(dense(p["wv"], x), cfg.num_kv_heads, hd)
        k_new = apply_rope(k_new, qpos, mode=cfg.rope)
        W = cache.k.shape[1]
        slot = (pos % W).reshape(1).long()
        cache = KVCache(
            k=cache.k.index_copy(1, slot, k_new),
            v=cache.v.index_copy(1, slot, v_new),
            pos=cache.pos.index_copy(1, slot, qpos),
        )
    allow = _mask(qpos, cache.pos, cfg, causal=not cross)        # (B, 1, W)
    w = _scores_and_weights(q, cache.k, allow, p, cfg, coeffs)
    out = _wv(w, cache.v, cfg)
    return dense(p["wo"], out), cache
