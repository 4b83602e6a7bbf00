"""Device resolution for the port's entry points.

Entry points default to ``cuda``. With no CUDA device present they raise:
the port never drops to the CPU on its own. The CPU is used only when the
caller asks for it (``device="cpu"``), and there every kernel wrapper runs
its plain PyTorch version.
"""
from __future__ import annotations

from typing import Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means ``cuda``, and a
    CUDA device without an index gets the current one.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and none is available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU by "
                "default and never falls back on its own. Pass device='cpu' "
                "to run the plain PyTorch versions on the CPU."
            )
        if dev.index is None:       # compare equal to the tensors placed there
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def sync(device: torch.device) -> None:
    """Wait for ``device``'s queued work, so a host clock read next times it
    (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def process_count() -> int:
    """Ranks in the default ``torch.distributed`` process group; 1 when
    none is initialised."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
