"""Causal softmax attention (online softmax): the wrapper of the CUDA kernel
and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attn.py::flash_attn``
(``pallas_call`` at :96, body ``_flash_kernel`` at :25) with the
hand-written Hopper kernel in ``csrc/flash_attn.cu``. What it computes:
scores ``q k^T * hd^-0.5`` in float32, causal positions above the diagonal
set to ``-1e30``, a running max, normaliser and accumulator over key tiles,
and ``out = acc / max(l, 1e-30)`` in ``q.dtype``. Its bound on the card is
the tensor-core rate for bf16 inputs and the float32 rate for float32
inputs (``chip_smoke.py`` computes both); the kernel itself is a simple one
on the CUDA cores (design in the source).

``flash_attn`` takes the plain version :func:`flash_attn_plain` for CPU
tensors and launches the kernel for CUDA tensors, or raises; there is no
fallback between the two. ``flash_attn.launches`` counts launches. The
TPU's tiling knobs (``block_q``, ``block_k``, ``interpret``) are gone: the
kernel picks its own tiles and masks the ragged edge of S and hd itself,
so any S is taken.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_inputs, raise_on

NEG_INF = -1e30                     # the TPU kernel's mask value (flash_attn.py:22)
MAX_HEAD_DIM = 256                  # FLASH_MAX_HD in csrc/flash_attn.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("flash_attn")
        lib.flash_attn_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p,
        ]
        lib.flash_attn_forward.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        lib.flash_attn_max_head_dim.argtypes = []
        lib.flash_attn_max_head_dim.restype = ctypes.c_int
        if lib.flash_attn_max_head_dim() != MAX_HEAD_DIM:
            raise RuntimeError("csrc/flash_attn.cu and flash_attn.py disagree on MAX_HEAD_DIM")
        _lib = lib
    return _lib


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "flash_attn: q, k and v must be (B, H, S, hd) of one shape (MHA layout); "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )


def flash_attn_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """What the TPU kernel computes, as plain softmax over whole rows: float32
    scores scaled by ``hd^-0.5``, ``-1e30`` above the diagonal when causal,
    ``exp(s - max)``, and the ``max(l, 1e-30)`` clamp of the normaliser.
    Returns ``q.dtype``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * q.shape[-1] ** -0.5
    if causal:
        n = q.shape[2]
        above = torch.ones((n, n), dtype=torch.bool, device=q.device).triu_(1)
        s.masked_fill_(above, NEG_INF)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_()                  # p, in place
    den = s.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
    return (torch.einsum("bhqk,bhkd->bhqd", s, v.float()) / den).to(q.dtype)


def _launch(q, k, v, causal):
    lib = _library()
    check_cuda_inputs("flash_attn", {"q": q, "k": k, "v": v}, _DTYPE_CODE)
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"flash_attn: q, k and v must share one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    bt, heads, s, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attn: head dim {hd} is above the kernel's {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attn_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bt * heads, s, hd, int(causal), _DTYPE_CODE[q.dtype], hd**-0.5, stream,
        )
    raise_on(rc, lib.flash_attn_error_string, "flash_attn")
    flash_attn.launches += 1
    return out


def flash_attn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """q/k/v: (B, H, S, hd) -> (B, H, S, hd) in ``q.dtype``. MHA layout
    (equal head counts). On CUDA, q, k and v are contiguous and share one
    dtype, float32 or bfloat16, and hd is at most ``MAX_HEAD_DIM``; any S
    is taken. CPU tensors take :func:`flash_attn_plain`."""
    _check_shapes(q, k, v)
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, causal=causal)
    return _launch(q, k, v, causal)


flash_attn.launches = 0
