"""Config registry (a copy of ``repro/configs``): importing this package
registers all assigned archs."""
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape, get_config, list_archs

# Assigned-pool architectures (each registers itself).
from repro_torch.configs import (  # noqa: F401
    chatglm3_6b,
    dbrx_132b,
    granite_moe_1b,
    hymba_1_5b,
    minitron_8b,
    paligemma_3b,
    qwen2_72b,
    rwkv6_1_6b,
    seamless_m4t_large_v2,
    yi_6b,
)

ASSIGNED_ARCHS = [
    "chatglm3-6b",
    "hymba-1.5b",
    "yi-6b",
    "rwkv6-1.6b",
    "paligemma-3b",
    "seamless-m4t-large-v2",
    "granite-moe-1b-a400m",
    "dbrx-132b",
    "qwen2-72b",
    "minitron-8b",
]

__all__ = [
    "ArchConfig",
    "InputShape",
    "INPUT_SHAPES",
    "ASSIGNED_ARCHS",
    "get_config",
    "list_archs",
]
