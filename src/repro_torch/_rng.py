"""Deterministic seed derivation for the port's random streams.

The reference derives its streams from JAX PRNG keys (``split``,
``fold_in``). Torch cannot reproduce those bits, so the port derives 64-bit
seeds with splitmix64 instead and seeds explicit ``torch.Generator``s from
them: the same inputs give the same streams on the same device, and
different inputs give independent ones.
"""
from __future__ import annotations

import torch

from repro_torch._device import DeviceLike

_MASK64 = (1 << 64) - 1


def splitmix64(z: int) -> int:
    """One splitmix64 step: a bijective 64-bit mix."""
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    """A 64-bit seed for the stream ``data`` under ``seed`` (the role of
    ``jax.random.fold_in``)."""
    return splitmix64(splitmix64(int(seed) & _MASK64) ^ (int(data) & _MASK64))


def generator(seed: int, device: DeviceLike = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with the 64-bit ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed) & _MASK64)
