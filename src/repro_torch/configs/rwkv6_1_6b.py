"""RWKV6-1.6B "Finch" [arXiv:2404.05892] — attention-free, data-dependent decay."""
from repro_torch.configs.base import ArchConfig, register


@register("rwkv6-1.6b")
def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-1.6b",
        family="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=0,             # attention-free
        num_kv_heads=0,
        head_dim=64,             # RWKV head size
        d_ff=7168,
        vocab_size=65536,
        ssm_kind="rwkv6",
        citation="arXiv:2404.05892",
    )
