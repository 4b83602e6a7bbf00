"""Collective bytes from a program listing, and the roofline arithmetic (the
port of ``repro/analysis/hlo.py``).

:func:`parse_collectives` reads the listing of a traced rank's step
(``analysis/program.py``), which writes each collective as HLO writes it:
``%n = bf16[4096,4096] all-gather(...)``, its result shape between the
``=`` and the kind. It sums the result bytes of every communication op, the
reference's per-chip traffic proxy: for an all-reduce its operand, for an
all-gather the bytes each rank receives. ``roofline_terms``,
``model_flops``, ``total_params``, ``model_traffic`` and ``active_params``
are copies.

The chip constants are keyword arguments that default to one NVIDIA H100
SXM's, from NVIDIA's data sheet (dense rates, 700 W): 989 TFLOP/s in
bf16, 3.35 TB/s of HBM, and 900 GB/s of NVLink (18 links, both
directions). A caller passes another chip's constants to reckon for it.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

COLLECTIVE_OPS = (
    "all-reduce",
    "all-gather",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    nb = _DTYPE_BYTES.get(dtype)
    if nb is None:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * nb


@dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    count_by_kind: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def to_dict(self) -> Dict:
        return {
            "total_bytes": self.total_bytes,
            "bytes_by_kind": dict(self.bytes_by_kind),
            "count_by_kind": dict(self.count_by_kind),
        }


def parse_collectives(hlo_text: str) -> CollectiveStats:
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        for op in COLLECTIVE_OPS:
            tok = f" {op}("
            # skip -start/-done duplicates (count the -start, which carries
            # the shape; plain ops appear once)
            if tok not in line and f" {op}-start(" not in line:
                continue
            if f" {op}-done(" in line:
                continue
            eq = line.find("=")
            if eq < 0:
                continue
            opi = line.find(op, eq)
            lhs = line[eq + 1 : opi]
            nbytes = sum(_shape_bytes(dt, dims) for dt, dims in _SHAPE_RE.findall(lhs))
            if nbytes:
                stats.bytes_by_kind[op] += nbytes
                stats.count_by_kind[op] += 1
            break
    return stats


H100_PEAK_FLOPS = 989e12     # bf16 FLOP/s, dense
H100_HBM_BW = 3.35e12        # bytes/s
H100_NVLINK_BW = 900e9       # bytes/s, all links


def roofline_terms(
    flops: float, hbm_bytes: float, collective_bytes: float, chips: int, *,
    peak_flops: float = H100_PEAK_FLOPS, hbm_bw: float = H100_HBM_BW,
    link_bw: float = H100_NVLINK_BW,
) -> Dict[str, float]:
    t_comp = flops / (chips * peak_flops)
    t_mem = hbm_bytes / (chips * hbm_bw)
    t_coll = collective_bytes / (chips * link_bw)
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]).replace("_s", "")
    return terms


def model_flops(cfg, shape, include_backward: bool) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for training,
    2*N*D for inference forward (D = processed tokens)."""
    n_active = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if include_backward else 2.0
    return mult * n_active * tokens


def total_params(cfg) -> float:
    """All parameters incl. embeddings and all experts."""
    d = cfg.d_model
    emb = cfg.padded_vocab() * d * (1 if cfg.tie_embeddings else 2)
    base = active_params(cfg)
    if cfg.family == "moe":
        # active_params counts topk experts; scale FFN part to all experts
        ffn_active = 3 * d * cfg.d_ff * cfg.experts_per_token * cfg.num_layers
        ffn_all = 3 * d * cfg.d_ff * cfg.num_experts * cfg.num_layers
        base = base - ffn_active + ffn_all + cfg.num_layers * d * cfg.num_experts
    return float(base + emb)


def model_traffic(cfg, shape) -> float:
    """Analytic GLOBAL HBM traffic (bytes) for one step, assuming full
    fusion (elementwise chains stay on chip; flash-style attention never
    spills scores)."""
    P = total_params(cfg)
    d, L = cfg.d_model, cfg.num_layers + cfg.encoder_layers
    B, S = shape.global_batch, shape.seq_len
    bpp = 2 if cfg.dtype == "bfloat16" else 4
    act = B * S * d * bpp
    kv_bytes = (
        2 * B * S * cfg.num_kv_heads * cfg.resolved_head_dim * bpp
        if cfg.num_kv_heads
        else 2 * B * (d // max(cfg.resolved_head_dim, 1)) * cfg.resolved_head_dim**2 * 4
    )
    logits = B * (S if shape.kind == "train" else 1) * cfg.padded_vocab() * 4

    if shape.kind == "train":
        # params: fwd read + remat re-read + bwd read = 3 reads; grad w+r;
        # adam: mu/nu read+write in f32 + param write
        param_traffic = P * (3 * bpp + 2 * bpp + 4 * 8 + bpp)
        stash = 2 * L * act              # write + read residual-stream stash
        attn_stream = 2 * L * kv_bytes   # K/V restreamed fwd+bwd
        return float(param_traffic + stash + attn_stream + 2 * logits)
    if shape.kind == "prefill":
        param_traffic = P * bpp
        stash = L * act
        return float(param_traffic + stash + L * kv_bytes + logits)
    # decode: weights + full KV-cache read dominate; MoE decode with large
    # batches touches all experts (documented approximation)
    W = min(S, cfg.sliding_window) if cfg.sliding_window else S
    cache_read = (
        L * 2 * B * W * cfg.num_kv_heads * cfg.resolved_head_dim * bpp
        if cfg.num_kv_heads
        else L * B * (d // max(cfg.resolved_head_dim, 1)) * cfg.resolved_head_dim**2 * 4
    )
    if cfg.is_encdec:
        cache_read += cfg.num_layers * 2 * B * (S // cfg.encoder_ratio) * (
            cfg.num_kv_heads * cfg.resolved_head_dim
        ) * bpp
    return float(P * bpp + cache_read + logits)


def active_params(cfg) -> float:
    """Active (per-token) parameter count, excluding embeddings."""
    d, ff, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    hd = cfg.resolved_head_dim
    if cfg.family == "ssm":
        # rwkv: 5 square mats + out + decay lora + channel mix
        per_layer = 6 * d * d + 2 * 32 * d + d * ff * 2 + d * d
    else:
        attn = d * cfg.num_heads * hd * 2 + d * cfg.num_kv_heads * hd * 2
        if cfg.family == "moe":
            ffn = 3 * d * ff * cfg.experts_per_token
        else:
            ffn = 3 * d * ff
        per_layer = attn + ffn
        if cfg.family == "hybrid":
            di = cfg.d_inner or 2 * d
            n = cfg.ssm_state or 16
            per_layer += 2 * d * di + di * (d + di + 2 * n)
    total = L * per_layer
    if cfg.is_encdec:
        # encoder layers + decoder cross-attention
        total += cfg.encoder_layers * (d * cfg.num_heads * hd * 4 + 3 * d * ff)
        total += cfg.num_layers * d * cfg.num_heads * hd * 4
    return float(total)
