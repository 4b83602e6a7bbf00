"""Mixture-of-Experts FFN with token-choice top-k routing (the port of
``repro/models/moe.py``).

Scatter/gather dispatch (no (T, E, C) one-hot dispatch tensor):

  1. router logits -> top-k experts + softmaxed gates per token;
  2. per-(token, slot) rank within its expert via a masked cumulative sum;
  3. tokens scatter-add (``index_add``) into a per-expert capacity buffer
     (E*C + 1, d) whose last row is the overflow bin;
  4. batched expert SwiGLU over (E, C, d);
  5. gather back per-(token, slot) and combine with gate weights.

Capacity C = ceil(T * k / E) * capacity_factor; overflowing tokens are
dropped (Switch behaviour) and counted in ``moe_drop_frac``. The
load-balance auxiliary loss is E * sum_e f_e * p_e.

``moe_ffn`` takes the expert-parallel ``moe_ffn_sharded`` exactly where the
reference does: under an active mesh with a ``model`` axis whose size
divides E. Otherwise ``moe_ffn_dense``, whose T, capacity, ranks and load
statistics span the whole batch: while a sharded step splits the batch
over ranks (``pspec.split``), its counts and means are summed over them.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import pspec
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
    """x: (B, S, d) -> (out, aux). Token-choice top-k with capacity."""
    mesh = pspec.active_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        if cfg.num_experts % mesh.shape["model"] == 0:
            return moe_ffn_sharded(p, cfg, x, mesh)
    return moe_ffn_dense(p, cfg, x)


def _route(p: Dict, cfg: ArchConfig, xt: torch.Tensor):
    """Router probabilities, the top-k experts and their renormalised gates."""
    logits = dense(p["router"], xt).to(torch.float32)               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, sel = top_k(probs, cfg.experts_per_token)            # (T, k)
    gates = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, sel, gates


def _ranks(sel: torch.Tensor, E: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (token, slot)'s rank within its selected expert (an exclusive
    cumulative count in token order), and the (T*k, E) one-hot."""
    T, k = sel.shape
    flat = F.one_hot(sel, E).reshape(T * k, E)
    ranks = torch.cumsum(flat, dim=0) - flat                        # exclusive
    return torch.sum(ranks * flat, dim=-1), flat


def _experts(experts: Dict, xt: torch.Tensor, gates: torch.Tensor, slot: torch.Tensor,
             n_exp: int, C: int, d_ff: int) -> torch.Tensor:
    """Scatter the (token, slot) pairs into the (n_exp*C + 1, d) capacity
    buffer at ``slot``, run the batched expert SwiGLU (on this rank's block
    of the ``d_ff`` columns when the expert leaves are split there) and
    combine the gate-weighted outputs per token (the overflow row is
    zero)."""
    T, d = xt.shape
    k = gates.shape[1]
    src = torch.repeat_interleave(xt, k, dim=0)                     # (T*k, d)
    buf = torch.zeros((n_exp * C + 1, d), dtype=xt.dtype, device=xt.device).index_add(
        0, slot, src)
    # batched expert SwiGLU: each weight carries the leading expert axis
    expert_out = swiglu(experts, buf[: n_exp * C].reshape(n_exp, C, d), d_ff)
    flat_out = torch.cat(
        [expert_out.reshape(n_exp * C, d), torch.zeros((1, d), dtype=xt.dtype, device=xt.device)],
        dim=0)
    per_slot = flat_out[slot].reshape(T, k, d)
    return torch.einsum("tk,tkd->td", gates.to(xt.dtype), per_slot)


def moe_ffn_dense(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """Reference single-device dispatch (scatter/gather), over the whole
    batch: when a sharded step splits its rows over ranks, T and the
    capacity count every rank's tokens, a token's rank within its expert
    counts the tokens of the ranks before it, and the load statistics are
    means over all of them."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    bm, axes = pspec.split()
    n_split = bm.axis_size(axes) if bm is not None else 1
    T = B * S
    C = int(-(-T * n_split * k // E) * cfg.moe_capacity_factor)
    xt = x.reshape(T, d)
    probs, sel, gates = _route(p, cfg, xt)
    rank, flat = _ranks(sel, E)
    expert = sel.reshape(T * k)
    if n_split > 1:
        # the tokens of the ranks before this one come first
        counts = bm.gather(flat.sum(0)[None], (axes,), axes)        # (n_split, E)
        rank = rank + counts[: bm.index(axes)].sum(0)[expert]
    keep = rank < C
    slot = torch.where(keep, expert * C + rank, E * C)              # overflow bin
    out = _experts(p["experts"], xt, gates, slot, E, C, cfg.d_ff)

    # Switch load-balance aux loss + router stats
    onehot0 = F.one_hot(sel[:, 0], E).to(torch.float32)
    if n_split > 1:
        n = T * n_split
        frac_tokens = bm.all_reduce(onehot0.sum(0), axes) / n
        mean_prob = bm.psum(probs.sum(0), axes) / n
        dropped = 1.0 - bm.all_reduce(keep.to(torch.float32).sum(), axes) / (n * k)
    else:
        frac_tokens = torch.mean(onehot0, dim=0)
        mean_prob = torch.mean(probs, dim=0)
        dropped = 1.0 - torch.mean(keep.to(torch.float32))
    aux_loss = E * torch.sum(frac_tokens * mean_prob)
    aux = {"moe_aux_loss": aux_loss, "moe_drop_frac": dropped}
    return out.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Expert parallelism over the mesh's "model" axis
# ---------------------------------------------------------------------------
#
# Megatron layouts replicate the token activations across "model", so every
# model rank already holds every token of its batch rows: dispatch needs no
# token movement. Each rank runs its own E/model experts over the tokens
# routed to them and contributes a partial output; one sum over "model"
# combines them. Routing (and the aux loss) is computed alike on every
# model rank, outside the expert-parallel region, so its gradient is the
# replicated one; only the tokens and gates that enter the region have
# their cotangents summed over "model" (``pbroadcast``).


def moe_ffn_sharded(p: Dict, cfg: ArchConfig, x: torch.Tensor, mesh) -> Tuple[torch.Tensor, Dict]:
    """Expert-parallel MoE on a rank's view of the mesh (bound to the process
    group, or traced): ``x`` is this rank's rows of the batch (split over
    the data axes, or all of it when the batch did not divide them:
    ``pspec.split``), ``p["experts"]`` this rank's E/model
    experts, the block of the expert axis at its model coordinate. Each rank
    routes its own T with its own capacity; the aux loss is averaged over
    the data axes; ``moe_drop_frac`` is reported as 0, as the reference's."""
    if not hasattr(mesh, "psum"):
        raise ValueError("moe_ffn_sharded needs a rank's view of the mesh, bound to the "
                         "process group (launch.mesh.bind_mesh) or traced "
                         "(launch.mesh.trace_mesh)")
    dp = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    _, split_axes = pspec.split()
    if set(split_axes) - set(dp):
        raise ValueError(f"the batch is split over {split_axes}, not the data axes {dp}")
    dp = dp if split_axes else ()      # a batch that did not divide is replicated
    E, k = cfg.num_experts, cfg.experts_per_token
    E_loc = E // mesh.shape["model"]
    lead = {leaf.shape[0] for leaf in tree_leaves(p["experts"])}
    if lead != {E_loc}:
        raise ValueError(f"expected this rank's {E_loc} of {E} experts, got {sorted(lead)}")
    B_l, S, d = x.shape
    T = B_l * S
    C = int(-(-T * k // E) * cfg.moe_capacity_factor)
    xt = x.reshape(T, d)
    probs, sel, gates = _route(p, cfg, xt)
    # rank within each (global) expert: identical on every model rank
    rank, _ = _ranks(sel, E)
    expert = sel.reshape(T * k)

    # keep only MY experts (model-rank local), under capacity
    local_e = expert - mesh.coords["model"] * E_loc
    mine = (local_e >= 0) & (local_e < E_loc) & (rank < C)
    slot = torch.where(mine, local_e * C + rank, E_loc * C)
    partial = _experts(p["experts"], mesh.pbroadcast(xt, ("model",)),
                       mesh.pbroadcast(gates, ("model",)), slot, E_loc, C, cfg.d_ff)
    out = mesh.psum(partial, ("model",))                            # combine experts

    frac = torch.mean(F.one_hot(sel[:, 0], E).to(torch.float32), dim=0)
    aux = E * torch.sum(frac * torch.mean(probs, dim=0))
    if dp:
        aux = mesh.psum(aux, dp) / mesh.axis_size(dp)                # avg over data
    return out.reshape(B_l, S, d), {
        "moe_aux_loss": aux, "moe_drop_frac": torch.zeros((), dtype=torch.float32,
                                                          device=x.device)}
