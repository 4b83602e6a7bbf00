"""Mamba-style selective SSM + the Hymba parallel-hybrid block
(arXiv:2411.13676), the port of ``repro/models/hybrid.py``: attention heads
and SSM heads consume the same layer input in parallel; their
(re-normalised) outputs are mean-fused.

Mamba block (simplified selective SSM, faithful state recurrence):
  in_proj -> (x, z); causal depthwise conv1d(k=4); x = silu(x)
  dt = softplus(x W_dt + b);  B_t = x W_B;  C_t = x W_C;  A = -exp(A_log)
  h_t = exp(dt * A) h_{t-1} + (dt * B_t) x_t        (state: (d_inner, n))
  y_t = h_t . C_t + D * x_t;  out = out_proj(y * silu(z))

The state recurrence loops over time in Python in float32, as the
reference's ``lax.scan``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import KVCache, attention_decode, attention_full, init_attention
from repro_torch.models.layers import Draw, Fill, dense, init_dense, init_rmsnorm, rmsnorm


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
                     device: torch.device) -> MambaState:
    di, n = d_inner_of(cfg), cfg.ssm_state or 16
    return MambaState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=dtype, device=device),
        h=torch.zeros((batch, di, n), dtype=torch.float32, device=device),
    )


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) (torch's ``softplus`` switches to
    the identity above a threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_scan(p: Dict, xc: torch.Tensor, h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan. xc: (B, S, di) post-conv/silu. Returns (y, h_final)."""
    A = -torch.exp(p["A_log"].to(torch.float32))                       # (di, n)
    dt = _softplus(dense(p["w_dt"], xc).to(torch.float32) + p["dt_bias"].to(torch.float32))
    Bm = dense(p["w_B"], xc).to(torch.float32)                         # (B, S, n)
    Cm = dense(p["w_C"], xc).to(torch.float32)                         # (B, S, n)
    decay = torch.exp(dt[..., None] * A[None, None])                   # (B,S,di,n)
    inp = (dt * xc.to(torch.float32))[..., None] * Bm[..., None, :]

    h = h0
    ys = []
    for t in range(xc.shape[1]):
        h = decay[:, t] * h + inp[:, t]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) + p["D"].to(torch.float32) * xc.to(torch.float32)
    return y, h


def mamba_seq(p: Dict, cfg: ArchConfig, x: torch.Tensor,
              state: MambaState) -> Tuple[torch.Tensor, MambaState]:
    """x: (B, S, d) -> (out, new_state)."""
    di = d_inner_of(cfg)
    xz = dense(p["in_proj"], x)
    xs, z = xz[..., :di], xz[..., di:]
    # causal depthwise conv with carried history
    hist = torch.cat([state.conv.to(xs.dtype), xs], dim=1)
    K = cfg.ssm_conv
    conv = sum(
        hist[:, i : i + xs.shape[1], :] * p["conv_w"][i][None, None, :] for i in range(K)
    ) + p["conv_b"]
    xc = F.silu(conv)
    y, h = _ssm_scan(p, xc, state.h)
    out = dense(p["out_proj"], (y.to(x.dtype) * F.silu(z)))
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, MambaState]:
    """Parallel attn + SSM over the sequence. Returns (out, k, v, state)."""
    attn_out, (k, v) = attention_full(p["attn"], cfg, x, positions, coeffs=coeffs)
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
