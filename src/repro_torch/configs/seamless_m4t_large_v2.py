"""SeamlessM4T-large-v2 [arXiv:2308.11596] — enc-dec; speech frontend stubbed
to frame embeddings."""
from repro_torch.configs.base import ArchConfig, register


@register("seamless-m4t-large-v2")
def config() -> ArchConfig:
    return ArchConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        num_layers=24,           # decoder layers
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,         # MHA (GQA kv=16 == heads)
        d_ff=8192,
        vocab_size=256206,
        encoder_ratio=4,         # enc frames = seq_len // 4
        sliding_window=8192,     # decoder-side long_500k variant
        citation="arXiv:2308.11596",
    )
