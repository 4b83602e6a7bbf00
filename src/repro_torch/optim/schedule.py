"""Learning-rate schedules (plain callables of the integer step), as
``repro/optim/schedule.py``: each returns a float32 0-d tensor computed in
the reference's order of operations."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    def fn(step):
        return torch.tensor(lr, dtype=torch.float32)

    return fn


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor * peak_lr``."""

    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        prog = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
        )
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)

    return fn
