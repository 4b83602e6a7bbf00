"""Architecture config schema + registry for the assigned public-pool archs
(a copy of ``repro/configs/base.py``).

Every architecture in repro_torch/configs/<id>.py instantiates ArchConfig with
the exact assigned hyperparameters (citation in ``citation``) and registers
itself. ``reduced()`` derives the CPU-smoke-test variant (2 layers,
d_model <= 512, <= 4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    citation: str = ""

    # attention
    rope: str = "standard"           # standard | 2d | none
    qkv_bias: bool = False
    attention_variant: str = "softmax"   # softmax | chebyshev (FedGAT-style)
    cheb_degree: int = 8
    cheb_domain: float = 4.0
    sliding_window: int = 0          # >0 enables sub-quadratic long decode

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM / hybrid
    ssm_state: int = 0
    ssm_kind: str = ""               # rwkv6 | mamba
    ssm_conv: int = 4
    d_inner: int = 0                 # mamba inner width (0 -> 2 * d_model)

    # encoder-decoder (audio) / prefix multimodal (vlm, audio stub frontends)
    encoder_layers: int = 0          # >0 -> enc-dec model
    prefix_len: int = 0              # VLM patch count (decoder-only prefix)
    encoder_ratio: int = 4           # enc frames = seq_len // ratio (audio)

    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"          # parameter/compute dtype for dry-run

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 64

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def padded_vocab(self, multiple: int = 256) -> int:
        return -(-self.vocab_size // multiple) * multiple

    def supports_long_decode(self) -> bool:
        """long_500k needs sub-quadratic attention: SSM state or sliding
        window (DESIGN.md §4)."""
        return self.attention_free or self.family == "hybrid" or self.sliding_window > 0

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, laptop-scale."""
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = min(self.num_kv_heads, max(1, heads // 2)) if self.num_kv_heads else 0
        d_model = min(self.d_model, 256)
        hd = d_model // heads if heads else 64
        return replace(
            self,
            num_layers=2,
            encoder_layers=2 if self.encoder_layers else 0,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.experts_per_token else 0,
            # no token drops at smoke scale: capacity covers worst-case routing
            moe_capacity_factor=float(max(self.num_experts, 1)),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            d_inner=min(self.d_inner, 2 * d_model) if self.d_inner else 0,
            prefix_len=min(self.prefix_len, 8) if self.prefix_len else 0,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch module imports)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}
