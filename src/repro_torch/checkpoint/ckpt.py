"""Read the reference's npz checkpoints (``repro/checkpoint/ckpt.py`` format).

A checkpoint is one ``.npz`` whose keys are the '/'-joined paths of the
saved tree's leaves (``params/0/W``, ...) plus ``__step__``. Writing waits
for the trainer's port.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], int]:
    """``({leaf path: array}, step)`` of the checkpoint at ``path``."""
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files if k != "__step__"}
        step = int(data["__step__"])
    return flat, step
