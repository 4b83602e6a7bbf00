"""ChatGLM3-6B [arXiv:2406.12793] — dense, 2D RoPE, GQA kv=2."""
from repro_torch.configs.base import ArchConfig, register


@register("chatglm3-6b")
def config() -> ArchConfig:
    return ArchConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        rope="2d",
        qkv_bias=True,           # ChatGLM uses QKV bias
        sliding_window=8192,     # long_500k variant (DESIGN.md §4)
        citation="arXiv:2406.12793",
    )
