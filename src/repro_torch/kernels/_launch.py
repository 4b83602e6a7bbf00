"""What every kernel wrapper does around a launch: check the tensors it
hands the kernel, and raise on the C function's return code."""
from __future__ import annotations

from typing import Callable, Iterable, Mapping

import torch


def check_cuda_inputs(
    what: str, tensors: Mapping[str, torch.Tensor], dtypes: Iterable[torch.dtype]
) -> None:
    """Raise unless every tensor lies on one CUDA device, has one of
    ``dtypes`` and is contiguous."""
    dtypes = tuple(dtypes)
    first_name, first = next(iter(tensors.items()))
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{what}: {name} is on {t.device}, {first_name} on "
                             f"{first.device}; all inputs must be on one CUDA device")
        if t.dtype not in dtypes:
            want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def raise_on(rc: int, error_string: Callable[[int], bytes], what: str) -> None:
    """Raise if a launch function returned a nonzero CUDA error code."""
    if rc != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: CUDA error {rc} ({error_string(rc).decode()})"
        )
