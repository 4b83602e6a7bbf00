"""Yi-6B [arXiv:2403.04652] — llama-architecture dense GQA."""
from repro_torch.configs.base import ArchConfig, register


@register("yi-6b")
def config() -> ArchConfig:
    return ArchConfig(
        name="yi-6b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        sliding_window=8192,     # long_500k variant
        citation="arXiv:2403.04652",
    )
