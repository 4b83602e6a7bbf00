from repro_torch.optim.adamw import (
    AdamState,
    adam_init,
    adam_update,
    clip_by_global_norm,
    sgd_update,
)
from repro_torch.optim.schedule import constant_schedule, cosine_schedule

__all__ = [
    "AdamState",
    "adam_init",
    "adam_update",
    "clip_by_global_norm",
    "sgd_update",
    "constant_schedule",
    "cosine_schedule",
]
