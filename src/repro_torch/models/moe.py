"""Mixture-of-Experts FFN with token-choice top-k routing (the port of
``repro/models/moe.py``'s single-device dispatch, ``moe_ffn_dense``).

Scatter/gather dispatch (no (T, E, C) one-hot dispatch tensor):

  1. router logits -> top-k experts + softmaxed gates per token;
  2. per-(token, slot) rank within its expert via a masked cumulative sum;
  3. tokens scatter-add (``index_add``) into a per-expert capacity buffer
     (E*C + 1, d) whose last row is the overflow bin;
  4. batched expert SwiGLU over (E, C, d);
  5. gather back per-(token, slot) and combine with gate weights.

Capacity C = ceil(T * k / E) * capacity_factor; overflowing tokens are
dropped (Switch behaviour) and counted in ``moe_drop_frac``. The
load-balance auxiliary loss is E * sum_e f_e * p_e. The expert-parallel
``moe_ffn_sharded`` needs a device mesh and is not ported.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._tree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import dense, init_dense, swiglu, swiglu_init


def init_moe(cfg: ArchConfig) -> Dict:
    experts = tree_map(lambda leaf: replace(leaf, shape=(cfg.num_experts,) + leaf.shape),
                       swiglu_init(cfg.d_model, cfg.d_ff))
    return {
        "router": init_dense(cfg.d_model, cfg.num_experts),
        "experts": experts,  # stacked on leading E axis
    }


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, ties broken by the lower index (a stable sort;
    ``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (out, aux). Token-choice top-k with capacity (the
    reference's mesh-less path)."""
    return moe_ffn_dense(p, cfg, x)


def moe_ffn_dense(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Reference single-device dispatch (scatter/gather)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    C = int(-(-T * k // E) * cfg.moe_capacity_factor)
    xt = x.reshape(T, d)

    logits = dense(p["router"], xt).to(torch.float32)               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = top_k(probs, k)                                # (T, k)
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)

    # rank of each (token, slot) within its selected expert
    onehot = F.one_hot(sel, E)                                      # (T, k, E)
    flat = onehot.reshape(T * k, E)
    ranks = torch.cumsum(flat, dim=0) - flat                        # exclusive
    rank = torch.sum(ranks * flat, dim=-1)                          # (T*k,)
    expert = sel.reshape(T * k)
    keep = rank < C
    slot = torch.where(keep, expert * C + rank, E * C)              # overflow bin

    # dispatch: scatter tokens into the capacity buffer
    src = torch.repeat_interleave(xt, k, dim=0)                     # (T*k, d)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device).index_add(0, slot, src)
    expert_in = buf[: E * C].reshape(E, C, d)

    # batched expert SwiGLU: each weight carries the leading E axis
    expert_out = swiglu(p["experts"], expert_in)                    # (E, C, d)

    # combine: gather processed tokens and gate-weighted sum over k slots
    flat_out = torch.cat(
        [expert_out.reshape(E * C, d), torch.zeros((1, d), dtype=x.dtype, device=x.device)],
        dim=0)
    per_slot = flat_out[slot].reshape(T, k, d)
    out = torch.einsum("tk,tkd->td", gates.to(x.dtype), per_slot)

    # Switch load-balance aux loss + router stats
    frac_tokens = torch.mean(F.one_hot(sel[:, 0], E).to(torch.float32), dim=0)
    mean_prob = torch.mean(probs, dim=0)
    aux_loss = E * torch.sum(frac_tokens * mean_prob)
    dropped = 1.0 - torch.mean(keep.to(torch.float32))
    aux = {"moe_aux_loss": aux_loss, "moe_drop_frac": dropped}
    return out.reshape(B, S, d), aux
