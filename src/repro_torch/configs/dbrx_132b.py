"""DBRX-132B [hf:databricks/dbrx-base] — 16-expert top-4 fine-grained MoE."""
from repro_torch.configs.base import ArchConfig, register


@register("dbrx-132b")
def config() -> ArchConfig:
    return ArchConfig(
        name="dbrx-132b",
        family="moe",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        num_experts=16,
        experts_per_token=4,
        sliding_window=8192,     # long_500k variant
        citation="hf:databricks/dbrx-base",
    )
