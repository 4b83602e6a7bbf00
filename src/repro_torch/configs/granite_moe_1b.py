"""Granite-3.0-1B-A400M [hf:ibm-granite/granite-3.0-1b-a400m-base] —
fine-grained MoE, 32 experts top-8."""
from repro_torch.configs.base import ArchConfig, register


@register("granite-moe-1b-a400m")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=512,                # per-expert FFN width (fine-grained)
        vocab_size=49155,
        num_experts=32,
        experts_per_token=8,
        sliding_window=8192,     # long_500k variant
        citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )
