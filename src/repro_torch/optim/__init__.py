from repro_torch.optim.adamw import AdamState, adam_init, adam_update, clip_by_global_norm

__all__ = ["AdamState", "adam_init", "adam_update", "clip_by_global_norm"]
