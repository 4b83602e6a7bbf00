"""Hymba-1.5B [arXiv:2411.13676] — hybrid parallel attention+mamba heads."""
from repro_torch.configs.base import ArchConfig, register


@register("hymba-1.5b")
def config() -> ArchConfig:
    return ArchConfig(
        name="hymba-1.5b",
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_kind="mamba",
        d_inner=3200,
        sliding_window=1024,     # Hymba uses SWA in most layers
        citation="arXiv:2411.13676",
    )
