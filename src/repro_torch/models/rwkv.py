"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free token mixing with
data-dependent decay (the port of ``repro/models/rwkv.py``).

* time-mix block: token shift with learned per-channel mix coefficients for
  r/k/v/w/g; data-dependent decay w_t = exp(-exp(w0 + tanh(x W_a) W_b));
* per-head linear-attention state S in R^{hd x hd}:
      y_t = r_t^T (S_{t-1} + (u * k_t) v_t^T)
      S_t = diag(w_t) S_{t-1} + k_t v_t^T
* channel-mix block: token shift + squared-ReLU MLP with receptance gate.

Tensor parallel (``layers.Region``): the time mix runs on the rank's block
of the channels (whole heads: ``wr``/``wk``/``wv``/``wg``/``wb``, ``u``,
``w0`` and the state), its ``ln_x`` norm summed over the model axis and
``wo`` row-split; the channel mix on the rank's ``d_ff`` block (``cm_k``
column-split, ``cm_v`` row-split, ``cm_r`` whole).

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
from repro_torch.models.layers import (Draw, Fill, Region, dense, dense_col, dense_row,
                                      init_dense, init_rmsnorm, rmsnorm, time_scan)

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


def _time_region(p: Dict, cfg: ArchConfig) -> Region:
    """The time mix's channels this rank computes: its block of ``wo``'s
    rows, which must be whole heads (the state is placed by heads)."""
    hd = _head_dim(cfg)
    r = Region(p["wo"]["w"].shape[0], cfg.d_model)
    if r.lo % hd or r.hi % hd:
        raise ValueError(f"the model axis cuts RWKV's heads of {hd} channels at "
                         f"[{r.lo}, {r.hi}); the state is placed by whole heads")
    return r


def _decay(p: Dict, xw: torch.Tensor, r: Region) -> torch.Tensor:
    """Data-dependent decay in (0, 1) of the region's channels:
    exp(-exp(w0 + lora(x))); ``xw`` has entered the region."""
    inner = torch.tanh(dense({k: r.whole(v) for k, v in p["wa"].items()}, xw))
    lora = dense_col(p["wb"], inner, r)
    return torch.exp(-torch.exp((r.take(p["w0"]) + lora).to(torch.float32)))


def _projections(p: Dict, xe: torch.Tensor, shifted: torch.Tensor, r: Region):
    """r, k, v, g (after silu) and the decay w of the region's channels from
    the token shift of ``xe`` (the normed input) by ``shifted``; both have
    entered the region."""
    def mixed(name):
        return _shift_mix(xe, shifted, r.enter(p["mix"][name]))

    return (dense_col(p["wr"], mixed("r"), r), dense_col(p["wk"], mixed("k"), r),
            dense_col(p["wv"], mixed("v"), r), F.silu(dense_col(p["wg"], mixed("g"), r)),
            _decay(p, mixed("w"), r))


def _time_out(p: Dict, y: torch.Tensor, g: torch.Tensor, r: Region,
              dtype: torch.dtype) -> torch.Tensor:
    """The time mix's output from the wkv ``y`` and the gate ``g`` of the
    region's channels (the norm spans every channel)."""
    y = rmsnorm(p["ln_x"], y.to(dtype), region=r)
    return dense_row(p["wo"], (y * g).to(dtype), r)


def _time_mix_step(
    p: Dict, cfg: ArchConfig, x: torch.Tensor, x_prev: torch.Tensor, S: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token. x: (B, d), S: (B, H, hd, hd) (this rank's heads). Returns
    (y, S_new)."""
    B, d = x.shape
    hd = _head_dim(cfg)
    reg = _time_region(p, cfg)
    H = (reg.hi - reg.lo) // hd
    r, k, v, g, w = _projections(p, reg.enter(x), reg.enter(x_prev), reg)  # w (B, d) in (0,1)

    rh = r.reshape(B, H, hd).to(torch.float32)
    kh = k.reshape(B, H, hd).to(torch.float32)
    vh = v.reshape(B, H, hd).to(torch.float32)
    wh = w.reshape(B, H, hd)
    uh = reg.take(p["u"]).reshape(H, hd).to(torch.float32)

    kv = kh[..., :, None] * vh[..., None, :]                     # k_t v_t^T
    att = S + uh[None, :, :, None] * kv                          # bonus on current
    y = torch.einsum("bhk,bhkv->bhv", rh, att)
    S_new = wh[..., None] * S + kv
    return _time_out(p, y.reshape(B, H * hd), g, reg, x.dtype), S_new


def _channel_mix(p: Dict, cfg: ArchConfig, xk: torch.Tensor, xr: torch.Tensor) -> torch.Tensor:
    """Squared-ReLU MLP of the shifted ``xk`` (on this rank's ``d_ff``
    block), gated by the receptance of ``xr`` (whole on every rank)."""
    rc = Region(p["cm_v"]["w"].shape[0], cfg.d_ff)
    k = torch.square(torch.relu(dense_col(p["cm_k"], rc.enter(xk), rc)))
    return torch.sigmoid(dense(p["cm_r"], xr)) * dense_row(p["cm_v"], k, rc)


def _channel_mix_step(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                      x_prev: torch.Tensor) -> torch.Tensor:
    return _channel_mix(p, cfg, _shift_mix(x, x_prev, p["cm_mix"]["k"]),
                        _shift_mix(x, x_prev, p["cm_mix"]["r"]))


def init_rwkv_state(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                    device: torch.device, heads: int = None) -> RWKVState:
    """An empty state of ``heads`` heads (default: all of them)."""
    d = cfg.d_model
    hd = _head_dim(cfg)
    H = heads or d // hd
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
    x = x + _channel_mix_step(p, cfg, xn2, state.x_prev_cm)
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
    reg = _time_region(p, cfg)
    H = (reg.hi - reg.lo) // hd

    # ---- time-mix block ----
    xn = rmsnorm(p["ln1"], x, eps)
    xe = reg.enter(xn)
    shifted = torch.cat([reg.enter(state.x_prev_tm)[:, None, :], xe[:, :-1, :]], dim=1)
    r, k, v, g, w = _projections(p, xe, shifted, reg)            # w (B, S, d) float32

    # The reference streams r/k/v in the model dtype and casts each step;
    # casting the whole sequence once gives the same values.
    rh = r.reshape(B, S, H, hd).to(torch.float32)
    kh = k.reshape(B, S, H, hd).to(torch.float32)
    vh = v.reshape(B, S, H, hd).to(torch.float32)
    wh = w.reshape(B, S, H, hd)
    uh = reg.take(p["u"]).reshape(H, hd).to(torch.float32)[None, :, :, None]

    def wkv_step(S_st, k_t, v_t, r_t, w_t, u):
        kv = k_t[..., :, None] * v_t[..., None, :]
        y_t = torch.einsum("bhk,bhkv->bhv", r_t, S_st + u * kv)
        return w_t[..., None] * S_st + kv, y_t

    S_st, y = time_scan(wkv_step, state.S, (kh, vh, rh, wh), (uh,))
    x = x + _time_out(p, y.reshape(B, S, H * hd), g, reg, x.dtype)

    # ---- channel-mix block ----
    xn2 = rmsnorm(p["ln2"], x, eps)
    shifted2 = torch.cat([state.x_prev_cm[:, None, :], xn2[:, :-1, :]], dim=1)
    xk = xn2 + (shifted2 - xn2) * p["cm_mix"]["k"]
    xr = xn2 + (shifted2 - xn2) * p["cm_mix"]["r"]
    x = x + _channel_mix(p, cfg, xk, xr)

    new_state = RWKVState(x_prev_tm=xn[:, -1, :], x_prev_cm=xn2[:, -1, :], S=S_st)
    return x, new_state
