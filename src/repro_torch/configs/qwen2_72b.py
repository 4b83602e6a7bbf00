"""Qwen2-72B [arXiv:2407.10671] — dense GQA with QKV bias."""
from repro_torch.configs.base import ArchConfig, register


@register("qwen2-72b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-72b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=29568,
        vocab_size=152064,
        qkv_bias=True,
        sliding_window=8192,     # long_500k variant
        citation="arXiv:2407.10671",
    )
