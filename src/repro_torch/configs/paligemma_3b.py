"""PaliGemma-3B [arXiv:2407.07726] — SigLIP + Gemma; vision stubbed to
patch embeddings, prefix-LM attention over the image prefix."""
from repro_torch.configs.base import ArchConfig, register


@register("paligemma-3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="paligemma-3b",
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=257216,
        prefix_len=256,          # SigLIP 224px -> 256 patch tokens (stub)
        sliding_window=8192,     # long_500k variant
        citation="arXiv:2407.07726",
    )
