from repro_torch.optim.adamw import AdamState, adam_init, adam_update

__all__ = ["AdamState", "adam_init", "adam_update"]
