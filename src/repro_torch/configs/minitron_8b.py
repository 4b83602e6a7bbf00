"""Minitron-8B [arXiv:2407.14679] — pruned Nemotron dense GQA."""
from repro_torch.configs.base import ArchConfig, register


@register("minitron-8b")
def config() -> ArchConfig:
    return ArchConfig(
        name="minitron-8b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=256000,
        sliding_window=8192,     # long_500k variant
        citation="arXiv:2407.14679",
    )
