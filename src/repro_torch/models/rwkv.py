"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free token mixing with
data-dependent decay (the port of ``repro/models/rwkv.py``).

* time-mix block: token shift with learned per-channel mix coefficients for
  r/k/v/w/g; data-dependent decay w_t = exp(-exp(w0 + tanh(x W_a) W_b));
* per-head linear-attention state S in R^{hd x hd}:
      y_t = r_t^T (S_{t-1} + (u * k_t) v_t^T)
      S_t = diag(w_t) S_{t-1} + k_t v_t^T
* channel-mix block: token shift + squared-ReLU MLP with receptance gate.

Training and prefill run every projection over the whole sequence and
loop over time in Python (``layers.time_scan``) for the state recurrence
alone, in float32, as the reference's ``lax.scan`` does (no kernel:
``wkv_chunked`` is not on this path). Decode carries (x_prev_tm, x_prev_cm, S).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (Draw, Fill, dense, init_dense, init_rmsnorm, rmsnorm,
                                      time_scan)

DECAY_RANK = 32


class RWKVState(NamedTuple):
    x_prev_tm: torch.Tensor   # (B, d)   last input of the time-mix block
    x_prev_cm: torch.Tensor   # (B, d)   last input of the channel-mix block
    S: torch.Tensor           # (B, H, hd, hd) linear-attention state, float32


def _head_dim(cfg: ArchConfig) -> int:
    return cfg.resolved_head_dim if cfg.num_heads else 64


def init_rwkv_layer(cfg: ArchConfig) -> Dict:
    d = cfg.d_model
    return {
        "ln1": init_rmsnorm(d),
        "ln2": init_rmsnorm(d),
        "mix": {  # per-channel token-shift mix coefficients for r,k,v,w,g
            name: Fill((d,), 0.5) for name in ("r", "k", "v", "w", "g")
        },
        "wr": init_dense(d, d),
        "wk": init_dense(d, d),
        "wv": init_dense(d, d),
        "wg": init_dense(d, d),
        "wo": init_dense(d, d),
        "w0": Fill((d,), -2.0),                  # decay bias
        "wa": init_dense(d, DECAY_RANK),         # decay LoRA in
        "wb": init_dense(DECAY_RANK, d),         # decay LoRA out
        "u": Draw((d,), 0.1),
        "ln_x": init_rmsnorm(d),
        # channel mix
        "cm_mix": {name: Fill((d,), 0.5) for name in ("k", "r")},
        "cm_k": init_dense(d, cfg.d_ff),
        "cm_v": init_dense(cfg.d_ff, d),
        "cm_r": init_dense(d, d),
    }


def _shift_mix(x: torch.Tensor, x_prev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """lerp(x, x_prev, mu) — RWKV token shift (single step)."""
    return x + (x_prev - x) * mu


def _decay(p: Dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay in (0, 1): exp(-exp(w0 + lora(x)))."""
    lora = dense(p["wb"], torch.tanh(dense(p["wa"], xw)))
    return torch.exp(-torch.exp((p["w0"] + lora).to(torch.float32)))


def _time_mix_step(
    p: Dict, cfg: ArchConfig, x: torch.Tensor, x_prev: torch.Tensor, S: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token. x: (B, d), S: (B, H, hd, hd). Returns (y, S_new)."""
    B, d = x.shape
    hd = _head_dim(cfg)
    H = d // hd
    r = dense(p["wr"], _shift_mix(x, x_prev, p["mix"]["r"]))
    k = dense(p["wk"], _shift_mix(x, x_prev, p["mix"]["k"]))
    v = dense(p["wv"], _shift_mix(x, x_prev, p["mix"]["v"]))
    g = F.silu(dense(p["wg"], _shift_mix(x, x_prev, p["mix"]["g"])))
    w = _decay(p, _shift_mix(x, x_prev, p["mix"]["w"]))          # (B, d) in (0,1)

    rh = r.reshape(B, H, hd).to(torch.float32)
    kh = k.reshape(B, H, hd).to(torch.float32)
    vh = v.reshape(B, H, hd).to(torch.float32)
    wh = w.reshape(B, H, hd)
    uh = p["u"].reshape(H, hd).to(torch.float32)

    kv = kh[..., :, None] * vh[..., None, :]                     # k_t v_t^T
    att = S + uh[None, :, :, None] * kv                          # bonus on current
    y = torch.einsum("bhk,bhkv->bhv", rh, att)
    S_new = wh[..., None] * S + kv
    y = y.reshape(B, d)
    y = rmsnorm(p["ln_x"], y.to(x.dtype))
    return dense(p["wo"], (y * g).to(x.dtype)), S_new


def _channel_mix_step(p: Dict, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    xk = _shift_mix(x, x_prev, p["cm_mix"]["k"])
    xr = _shift_mix(x, x_prev, p["cm_mix"]["r"])
    k = torch.square(torch.relu(dense(p["cm_k"], xk)))
    return torch.sigmoid(dense(p["cm_r"], xr)) * dense(p["cm_v"], k)


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                    device: torch.device) -> RWKVState:
    d = cfg.d_model
    hd = _head_dim(cfg)
    H = d // hd
    return RWKVState(
        x_prev_tm=torch.zeros((batch, d), dtype=dtype, device=device),
        x_prev_cm=torch.zeros((batch, d), dtype=dtype, device=device),
        S=torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
    )


def rwkv_layer_step(
    p: Dict, cfg: ArchConfig, x: torch.Tensor, state: RWKVState, eps: float
) -> Tuple[torch.Tensor, RWKVState]:
    """One token through time-mix + channel-mix (with pre-norms)."""
    xn = rmsnorm(p["ln1"], x, eps)
    y, S_new = _time_mix_step(p, cfg, xn, state.x_prev_tm, state.S)
    x = x + y
    xn2 = rmsnorm(p["ln2"], x, eps)
    x = x + _channel_mix_step(p, xn2, state.x_prev_cm)
    return x, RWKVState(x_prev_tm=xn, x_prev_cm=xn2, S=S_new)


def rwkv_layer_seq(
    p: Dict, cfg: ArchConfig, x: torch.Tensor, state: RWKVState, eps: float
) -> Tuple[torch.Tensor, RWKVState]:
    """Full sequence. x: (B, S, d).

    Every dense projection (r/k/v/w/g, decay LoRA, channel mix) runs over
    the whole sequence outside the time loop, which carries only the
    per-head float32 state update: numerically the reference's scan.
    """
    B, S, d = x.shape
    hd = _head_dim(cfg)
    H = d // hd

    # ---- time-mix block ----
    xn = rmsnorm(p["ln1"], x, eps)
    shifted = torch.cat([state.x_prev_tm[:, None, :], xn[:, :-1, :]], dim=1)

    def mixed(name):
        return xn + (shifted - xn) * p["mix"][name]

    r = dense(p["wr"], mixed("r"))
    k = dense(p["wk"], mixed("k"))
    v = dense(p["wv"], mixed("v"))
    g = F.silu(dense(p["wg"], mixed("g")))
    w = _decay(p, mixed("w"))                                    # (B, S, d) float32

    # The reference streams r/k/v in the model dtype and casts each step;
    # casting the whole sequence once gives the same values.
    rh = r.reshape(B, S, H, hd).to(torch.float32)
    kh = k.reshape(B, S, H, hd).to(torch.float32)
    vh = v.reshape(B, S, H, hd).to(torch.float32)
    wh = w.reshape(B, S, H, hd)
    uh = p["u"].reshape(H, hd).to(torch.float32)[None, :, :, None]

    def wkv_step(S_st, k_t, v_t, r_t, w_t, u):
        kv = k_t[..., :, None] * v_t[..., None, :]
        y_t = torch.einsum("bhk,bhkv->bhv", r_t, S_st + u * kv)
        return w_t[..., None] * S_st + kv, y_t

    S_st, y = time_scan(wkv_step, state.S, (kh, vh, rh, wh), (uh,))
    y = y.reshape(B, S, d)                                       # (B, S, d)
    y = rmsnorm(p["ln_x"], y.to(x.dtype))
    x = x + dense(p["wo"], (y * g).to(x.dtype))

    # ---- channel-mix block ----
    xn2 = rmsnorm(p["ln2"], x, eps)
    shifted2 = torch.cat([state.x_prev_cm[:, None, :], xn2[:, :-1, :]], dim=1)
    xk = xn2 + (shifted2 - xn2) * p["cm_mix"]["k"]
    xr = xn2 + (shifted2 - xn2) * p["cm_mix"]["r"]
    kcm = torch.square(torch.relu(dense(p["cm_k"], xk)))
    x = x + torch.sigmoid(dense(p["cm_r"], xr)) * dense(p["cm_v"], kcm)

    new_state = RWKVState(x_prev_tm=xn[:, -1, :], x_prev_cm=xn2[:, -1, :], S=S_st)
    return x, new_state
