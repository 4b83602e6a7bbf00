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

Tensor parallel (``layers.Region``): a rank computes the query heads that
cover its block of ``wo``'s rows, the block of the attention output it
multiplies, and the KV heads they read; ``wo``'s partial products are
summed over the model axis. Where the block is whole heads, ``wq`` is the
rank's block too; where it cuts inside a head, the step gathers ``wq``
(``launch.steps.tp_gathers``) and the rank computes the heads its block
touches and keeps its columns of their output. ``wk``/``wv`` likewise:
their block when it is whole KV heads, else the gathered or replicated
leaf. A cache holds the KV heads of ``wk``'s block (all of them when the
block is the whole leaf), as ``launch.sharding.cache_shardings`` places it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.chebyshev import eval_power_series
from repro_torch.models.layers import (Draw, Region, apply_rope, dense_col, dense_row, held,
                                      init_dense)

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


class _Heads(NamedTuple):
    """What a rank computes of one attention: ``region`` over the H·hd
    columns of its output (``wo``'s rows), the query heads [h0, h1) that
    cover it, and their KV heads [k0, k1)."""
    region: Region
    h0: int
    h1: int
    k0: int
    k1: int


def _heads(p: Dict, cfg: ArchConfig) -> _Heads:
    hd = cfg.resolved_head_dim
    r = Region(p["wo"]["w"].shape[0], cfg.num_heads * hd)
    h0, h1 = r.lo // hd, -(-r.hi // hd)
    G = cfg.num_heads // cfg.num_kv_heads
    return _Heads(r, h0, h1, h0 // G, (h1 - 1) // G + 1)


def _project_q(p: Dict, cfg: ArchConfig, xb: torch.Tensor, hp: _Heads) -> torch.Tensor:
    hd = cfg.resolved_head_dim
    q = dense_col(p["wq"], xb, hp.region, hp.h0 * hd, hp.h1 * hd, cfg.num_heads * hd)
    return _split_heads(q, hp.h1 - hp.h0, hd)


def _cache_heads(p: Dict, cfg: ArchConfig) -> Tuple[int, int]:
    """The KV heads a cache holds: those of ``wk``'s block (all of them when
    this rank holds the whole leaf)."""
    hd = cfg.resolved_head_dim
    lo, hi = held(p["wk"]["w"].shape[-1], cfg.num_kv_heads * hd)
    return lo // hd, hi // hd


def project_kv(p: Dict, cfg: ArchConfig, xb: torch.Tensor, hp: _Heads, for_cache: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys and values (not roped) of the KV heads this rank reads, or with
    ``for_cache`` of the heads its cache holds (``_cache_heads``); ``xb`` has
    entered ``hp.region``."""
    hd, full = cfg.resolved_head_dim, cfg.num_kv_heads * cfg.resolved_head_dim
    c0, c1 = _cache_heads(p, cfg) if for_cache else (hp.k0, hp.k1)
    k = dense_col(p["wk"], xb, hp.region, c0 * hd, c1 * hd, full)
    v = dense_col(p["wv"], xb, hp.region, c0 * hd, c1 * hd, full)
    return _split_heads(k, c1 - c0, hd), _split_heads(v, c1 - c0, hd)


def _read(k: torch.Tensor, v: torch.Tensor, c0: int, hp: _Heads, cfg: ArchConfig):
    """k, v (B, S, heads [c0, ..), hd) cut to the KV heads of the query
    heads [h0, h1), in the grouping ``_scores_and_weights`` reads: KV heads
    with equal groups of consecutive query heads, or, where the rank's
    query heads do not group so, one KV head per query head."""
    k, v = k[:, :, hp.k0 - c0:hp.k1 - c0], v[:, :, hp.k0 - c0:hp.k1 - c0]
    G = cfg.num_heads // cfg.num_kv_heads
    nh, nk = hp.h1 - hp.h0, hp.k1 - hp.k0
    idx = [(h // G) - hp.k0 for h in range(hp.h0, hp.h1)]
    if nh % nk == 0 and idx == [i // (nh // nk) for i in range(nh)]:
        return k, v
    return k[:, :, idx], v[:, :, idx]


def _series_vectors(p: Dict, cfg: ArchConfig, hp: _Heads):
    """The chebyshev variant's (a1, a2) rows of this rank's query heads
    (None for softmax)."""
    if cfg.attention_variant != "chebyshev":
        return None
    return tuple(hp.region.take(p[n], hp.h0, hp.h1, cfg.num_heads, dim=0) for n in ("a1", "a2"))


def _scores_and_weights(
    q: torch.Tensor, k: torch.Tensor, allow: torch.Tensor, a, cfg: ArchConfig, coeffs
) -> torch.Tensor:
    """Returns attention weights (B, H, Sq, Sk) of the query heads in ``q``
    against the KV heads in ``k`` (``_read``'s grouping); ``a`` is
    ``_series_vectors``'."""
    hd = cfg.resolved_head_dim
    kv = k.shape[2]
    groups = q.shape[2] // kv
    qg = q.reshape(q.shape[0], q.shape[1], kv, groups, hd)
    if cfg.attention_variant == "chebyshev":
        a1 = a[0].reshape(kv, groups, hd).to(torch.float32)
        a2 = a[1].reshape(kv, groups, hd).to(torch.float32)
        sq = torch.einsum("bsvgh,vgh->bvgs", qg.to(torch.float32), a1)
        sk = torch.einsum("btvh,vgh->bvgt", k.to(torch.float32), a2)
        scores = sq[..., :, None] + sk[..., None, :]             # (B,KV,G,Sq,Sk)
    else:
        scores = torch.einsum("bsvgh,btvh->bvgst", qg, k) * (hd ** -0.5)
    B, KV, G, Sq, Sk = scores.shape
    scores = scores.reshape(B, KV * G, Sq, Sk)
    return _weights(scores, allow[:, None], cfg.attention_variant, coeffs)


def _wv(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """weights (B, H, Sq, Sk), v (B, Sk, KV, hd) -> (B, Sq, H*hd)."""
    B, H, Sq, Sk = weights.shape
    kv, hd = v.shape[2], v.shape[3]
    wg = weights.reshape(B, kv, H // kv, Sq, Sk)
    out = torch.einsum("bvgst,btvh->bsvgh", wg.to(v.dtype), v)
    return out.reshape(B, Sq, H * hd)


def _out(p: Dict, cfg: ArchConfig, out: torch.Tensor, hp: _Heads) -> torch.Tensor:
    """``wo`` on the region's columns of the heads' output (B, S, heads·hd)."""
    r, base = hp.region, hp.h0 * cfg.resolved_head_dim
    if r.lo != base or r.hi - r.lo != out.shape[-1]:
        out = out[..., r.lo - base:r.hi - base]
    return dense_row(p["wo"], out, r)


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
    for_cache: bool = False,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence attention. x: (B, S, d), positions: (B, S).

    Returns (out (B, S, d), (k, v)) — k/v already roped, for cache building,
    of the KV heads this rank reads or, with ``for_cache``, of those its
    cache holds. ``kv_override`` supplies external keys/values
    (cross-attention) of the KV heads this rank reads (``cross_kv``):
    (k, v, k_positions).
    """
    B, S, _ = x.shape
    hp = _heads(p, cfg)
    xb = hp.region.enter(x)
    q = apply_rope(_project_q(p, cfg, xb, hp), positions, mode=cfg.rope)
    if kv_override is None:
        k, v = project_kv(p, cfg, xb, hp, for_cache)
        k = apply_rope(k, positions, mode=cfg.rope)
        k_pos = positions
        c0 = _cache_heads(p, cfg)[0] if for_cache else hp.k0
    else:
        k, v, k_pos = kv_override
        c0 = hp.k0
    kr, vr = _read(k, v, c0, hp, cfg)
    a = _series_vectors(p, cfg, hp)

    n_chunks = max(S // q_chunk, 1)
    if S % q_chunk != 0:
        n_chunks, q_chunk = 1, S  # fallback: single chunk

    outs = []
    for idx in range(n_chunks):
        rows = slice(idx * q_chunk, (idx + 1) * q_chunk)
        allow = _mask(positions[:, rows], k_pos, cfg, causal)      # (B, Cq, Sk)
        w = _scores_and_weights(q[:, rows], kr, allow, a, cfg, coeffs)
        outs.append(_wv(w, vr))
    out = outs[0] if n_chunks == 1 else torch.cat(outs, dim=1)
    return _out(p, cfg, out, hp), (k, v)


def cross_kv(p: Dict, cfg: ArchConfig, memory: torch.Tensor, for_cache: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention keys and values of ``memory`` (B, Sm, d): of the KV
    heads this rank reads (``attention_full``'s ``kv_override``), or with
    ``for_cache`` of those its cache holds."""
    hp = _heads(p, cfg)
    return project_kv(p, cfg, hp.region.enter(memory), hp, for_cache)


def init_kv_cache(cfg: ArchConfig, batch: int, cache_len: int, dtype: torch.dtype,
                  device: torch.device, kv_heads: int = None) -> KVCache:
    """An empty cache of ``kv_heads`` KV heads (default: all of them)."""
    hd = cfg.resolved_head_dim
    shape = (batch, cache_len, kv_heads or cfg.num_kv_heads, hd)
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
    place: the new one is returned. It holds the KV heads of ``wk``'s block
    (``_cache_heads``).
    """
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    hp = _heads(p, cfg)
    xb = hp.region.enter(x)
    qpos = pos.reshape(1, 1).expand(B, 1).to(torch.int32)
    q = apply_rope(_project_q(p, cfg, xb, hp), qpos, mode=cfg.rope)
    c0 = held(cache.k.shape[2] * hd, cfg.num_kv_heads * hd)[0] // hd

    if not cross:
        k_new, v_new = project_kv(p, cfg, xb, hp, for_cache=True)
        k_new = apply_rope(k_new, qpos, mode=cfg.rope)
        W = cache.k.shape[1]
        slot = (pos % W).reshape(1).long()
        cache = KVCache(
            k=cache.k.index_copy(1, slot, k_new),
            v=cache.v.index_copy(1, slot, v_new),
            pos=cache.pos.index_copy(1, slot, qpos),
        )
    allow = _mask(qpos, cache.pos, cfg, causal=not cross)        # (B, 1, W)
    kr, vr = _read(cache.k, cache.v, c0, hp, cfg)
    w = _scores_and_weights(q, kr, allow, _series_vectors(p, cfg, hp), cfg, coeffs)
    return _out(p, cfg, _wv(w, vr), hp), cache
