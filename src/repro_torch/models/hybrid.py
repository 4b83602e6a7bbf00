"""Mamba-style selective SSM + the Hymba parallel-hybrid block
(arXiv:2411.13676), the port of ``repro/models/hybrid.py``: attention heads
and SSM heads consume the same layer input in parallel; their
(re-normalised) outputs are mean-fused.

Mamba block (simplified selective SSM, faithful state recurrence):
  in_proj -> (x, z); causal depthwise conv1d(k=4); x = silu(x)
  dt = softplus(x W_dt + b);  B_t = x W_B;  C_t = x W_C;  A = -exp(A_log)
  h_t = exp(dt * A) h_{t-1} + (dt * B_t) x_t        (state: (d_inner, n))
  y_t = h_t . C_t + D * x_t;  out = out_proj(y * silu(z))

The state recurrence loops over time in Python (``layers.time_scan``) in
float32, as the reference's ``lax.scan``.

Tensor parallel (``layers.Region``): Mamba runs on the rank's block of the
d_inner channels (``conv_w``/``conv_b``, ``dt_bias``, ``D``, ``A_log``, the
state, and ``w_dt``'s output columns, whose input is the channels
all-gathered), ``w_B``/``w_C`` contract over d_inner and are summed over the
model axis before the scan, and ``out_proj`` is row-split. ``in_proj``'s
contiguous column blocks do not hold the matching channels of its x and z
halves, so the step gathers it (``launch.steps.tp_gathers``) and each rank
takes its channels of both. The attention heads follow
``models.attention``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import KVCache, attention_decode, attention_full, init_attention
from repro_torch.models.layers import (Draw, Fill, Region, dense, dense_col, dense_row,
                                      init_dense, init_rmsnorm, rmsnorm, time_scan)


class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, K-1, d_inner) causal-conv history
    h: torch.Tensor       # (B, d_inner, n) SSM state, float32


def d_inner_of(cfg: ArchConfig) -> int:
    return cfg.d_inner or 2 * cfg.d_model


def init_mamba(cfg: ArchConfig) -> Dict:
    d, di, n = cfg.d_model, d_inner_of(cfg), cfg.ssm_state or 16
    return {
        "in_proj": init_dense(d, 2 * di),
        "conv_w": Draw((cfg.ssm_conv, di), 0.2),
        "conv_b": Fill((di,), 0.0),
        "w_dt": init_dense(di, di),
        "dt_bias": Fill((di,), -2.0),
        "w_B": init_dense(di, n),
        "w_C": init_dense(di, n),
        "A_log": Fill((di, n), np.log(np.arange(1, n + 1, dtype=np.float32))),
        "D": Fill((di,), 1.0),
        "out_proj": init_dense(di, d),
    }


def init_mamba_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device: torch.device, d_inner: int = None) -> MambaState:
    """An empty state of ``d_inner`` channels (default: all of them)."""
    di, n = d_inner or d_inner_of(cfg), cfg.ssm_state or 16
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device),
        h=torch.zeros((batch, di, n), dtype=torch.float32, device=device),
    )


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (torch's ``softplus`` switches to
    the identity above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_scan(p: Dict, xc: torch.Tensor, h0: torch.Tensor,
              r: Region) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan. xc: (B, S, di) post-conv/silu, the region's channels.
    Returns (y, h_final)."""
    def contract(w):       # (B, S, n): a product over every channel
        return r.enter(r.leave(xc @ r.take(w["w"], dim=0))).to(torch.float32)

    A = -torch.exp(r.take(p["A_log"], dim=0).to(torch.float32))       # (di, n)
    dt = _softplus(dense_col(p["w_dt"], r.gather(xc), r).to(torch.float32)
                   + r.take(p["dt_bias"]).to(torch.float32))
    Bm = contract(p["w_B"])                                            # (B, S, n)
    Cm = contract(p["w_C"])                                            # (B, S, n)
    decay = torch.exp(dt[..., None] * A[None, None])                   # (B,S,di,n)
    inp = (dt * xc.to(torch.float32))[..., None] * Bm[..., None, :]

    def ssm_step(h, decay_t, inp_t, c_t):
        h = decay_t * h + inp_t
        return h, torch.einsum("bdn,bn->bd", h, c_t)

    h, y = time_scan(ssm_step, h0, (decay, inp, Cm))
    y = y + r.take(p["D"]).to(torch.float32) * xc.to(torch.float32)
    return y, h


def mamba_seq(p: Dict, cfg: ArchConfig, x: torch.Tensor,
              state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """x: (B, S, d) -> (out, new_state)."""
    di = d_inner_of(cfg)
    r = Region(p["out_proj"]["w"].shape[0], di)
    if r.tp is None:
        xz = dense(p["in_proj"], x)
        xs, z = xz[..., :di], xz[..., di:]
    else:            # this rank's channels of the x half and of the z half
        xb, w = r.enter(x), r.whole(p["in_proj"]["w"], 2 * di)
        xs, z = xb @ w[:, r.lo:r.hi], xb @ w[:, di + r.lo:di + r.hi]
    # causal depthwise conv with carried history
    hist = torch.cat([state.conv.to(xs.dtype), xs], dim=1)
    K = cfg.ssm_conv
    conv_w = r.take(p["conv_w"])
    conv = sum(
        hist[:, i : i + xs.shape[1], :] * conv_w[i][None, None, :] for i in range(K)
    ) + r.take(p["conv_b"])
    xc = F.silu(conv)
    y, h = _ssm_scan(p, xc, state.h, r)
    out = dense_row(p["out_proj"], (y.to(x.dtype) * F.silu(z)), r)
    new_state = MambaState(conv=hist[:, -(K - 1):, :].to(state.conv.dtype), h=h)
    return out, new_state


def mamba_step(p: Dict, cfg: ArchConfig, x: torch.Tensor,
               state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """Single-token decode. x: (B, 1, d)."""
    return mamba_seq(p, cfg, x, state)


# ---------------------------------------------------------------------------
# Hymba parallel-hybrid block
# ---------------------------------------------------------------------------

def init_hymba_block(cfg: ArchConfig) -> Dict:
    return {
        "attn": init_attention(cfg),
        "mamba": init_mamba(cfg),
        "norm_attn": init_rmsnorm(cfg.d_model),
        "norm_ssm": init_rmsnorm(cfg.d_model),
    }


def hymba_block_seq(
    p: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    state: MambaState,
    coeffs,
    for_cache: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, MambaState]:
    """Parallel attn + SSM over the sequence. Returns (out, k, v, state)
    (k, v of the KV heads a cache holds with ``for_cache``: see
    ``attention_full``)."""
    attn_out, (k, v) = attention_full(p["attn"], cfg, x, positions, coeffs=coeffs,
                                      for_cache=for_cache)
    ssm_out, state = mamba_seq(p["mamba"], cfg, x, state)
    out = 0.5 * (
        rmsnorm(p["norm_attn"], attn_out, cfg.norm_eps)
        + rmsnorm(p["norm_ssm"], ssm_out, cfg.norm_eps)
    )
    return out, k, v, state


def hymba_block_step(
    p: Dict,
    cfg: ArchConfig,
    x: torch.Tensor,
    pos: torch.Tensor,
    kv: KVCache,
    state: MambaState,
    coeffs,
) -> Tuple[torch.Tensor, KVCache, MambaState]:
    attn_out, kv = attention_decode(p["attn"], cfg, x, pos, kv, coeffs=coeffs)
    ssm_out, state = mamba_step(p["mamba"], cfg, x, state)
    out = 0.5 * (
        rmsnorm(p["norm_attn"], attn_out, cfg.norm_eps)
        + rmsnorm(p["norm_ssm"], ssm_out, cfg.norm_eps)
    )
    return out, kv, state
