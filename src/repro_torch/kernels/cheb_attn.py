"""Fused polynomial-attention aggregation: the wrapper of the CUDA kernel.

Replaces the Pallas TPU kernel ``repro/kernels/cheb_attn.py::cheb_attn``
(``pallas_call`` at :146) with the hand-written Hopper kernel in
``csrc/cheb_attn.cu``. The kernel is bound by memory (it reads the scores,
the neighbour features and the mask once and writes the output once;
~2.1 GB, ~0.63 ms at 3.35 TB/s for the sbm_1m serving shape). Its design:
one block per node tile x feature tile with every head inside the block,
so each neighbour-feature tile is read from device memory once for all
heads; the polynomial weights and denominators of the tile live in shared
memory.

CPU tensors take the plain version (:func:`repro_torch.kernels.ref.cheb_attn_ref`);
CUDA tensors launch the kernel or raise. There is no fallback between the two.
``cheb_attn.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cheb_attn_ref

MAX_COEFFS = 64                     # CHEB_MAX_COEFFS in csrc/cheb_attn.cu
_THREADS = 256
_SMEM_DEFAULT = 48 * 1024           # dynamic shared memory without opt-in
_SMEM_MAX = 227 * 1024              # H100: most a block can opt in to

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("cheb_attn")
        lib.cheb_attn_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.cheb_attn_forward.restype = ctypes.c_int
        lib.cheb_attn_error_string.argtypes = [ctypes.c_int]
        lib.cheb_attn_error_string.restype = ctypes.c_char_p
        lib.cheb_attn_max_coeffs.argtypes = []
        lib.cheb_attn_max_coeffs.restype = ctypes.c_int
        if lib.cheb_attn_max_coeffs() != MAX_COEFFS:
            raise RuntimeError("csrc/cheb_attn.cu and cheb_attn.py disagree on MAX_COEFFS")
        _lib = lib
    return _lib


def launch_config(heads: int, b: int, d: int) -> Tuple[int, int, int]:
    """``(node_tile, d_tile, smem_bytes)`` for one launch.

    ``d_tile`` is the next power of two >= D (at most 256) so a warp's
    loads run along D; ``node_tile`` fills the block to 256 threads, cut so
    the tile's weights fit the default 48 KB of shared memory. The size
    formula matches the shared-memory layout in ``csrc/cheb_attn.cu``.
    """
    d_tile = min(_THREADS, 1 << max(d - 1, 0).bit_length())
    per_node = 4 * heads * ((b | 1) + 1)          # weights (odd stride) + den
    fixed = 4 * MAX_COEFFS
    node_tile = max(1, min(_THREADS // d_tile, (_SMEM_DEFAULT - fixed) // per_node))
    smem = fixed + node_tile * per_node
    if smem > _SMEM_MAX:
        raise ValueError(
            f"cheb_attn: H*B = {heads}*{b} needs {smem} bytes of shared memory "
            f"for one node, above the {_SMEM_MAX} a block can have"
        )
    return node_tile, d_tile, smem


def _batched(x, h_nb, mask):
    """Views of the three layouts as (G, H, N, B), (G, N, B, D), (G, N, B),
    checking that the shapes agree."""
    if x.dim() == 2:
        x = x[None]
    if x.dim() == 3:
        x, h_nb, mask = x[None], h_nb[None], mask[None]
    if x.dim() != 4:
        raise ValueError(f"x must be (N,B), (H,N,B) or (G,H,N,B); got {tuple(x.shape)}")
    g, _, n, b = x.shape
    if h_nb.dim() != 4 or tuple(h_nb.shape[:3]) != (g, n, b) or tuple(mask.shape) != (g, n, b):
        raise ValueError(
            f"cheb_attn: shapes disagree: x {tuple(x.shape)}, h_nb "
            f"{tuple(h_nb.shape)}, mask {tuple(mask.shape)} (as batched layouts)"
        )
    return x, h_nb, mask


def _launch(x, h_nb, mask, coeffs):
    lib = _library()
    out_shape = x.shape[:-1] + h_nb.shape[-1:]
    x4, h4, m4 = _batched(x, h_nb, mask)
    tensors = {"x": x4, "h_nb": h4, "mask": m4, "coeffs": coeffs}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"cheb_attn: {name} is on {t.device}, x on {x.device}; "
                             "all inputs must be on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"cheb_attn: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cheb_attn: {name} must be contiguous")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors.values()):
        raise NotImplementedError(
            "cheb_attn on CUDA has no backward kernel yet; call it under "
            "torch.no_grad() or torch.inference_mode()"
        )
    p = coeffs.numel()
    if coeffs.dim() != 1 or not 1 <= p <= MAX_COEFFS:
        raise ValueError(f"cheb_attn: coeffs must be 1-D with 1..{MAX_COEFFS} "
                         f"entries, got shape {tuple(coeffs.shape)}")
    g, heads, n, b = x4.shape
    d = h4.shape[-1]
    out = torch.empty((g, heads, n, d), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out.reshape(out_shape)
    node_tile, d_tile, smem = launch_config(heads, b, d)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cheb_attn_forward(
            x4.data_ptr(), h4.data_ptr(), m4.data_ptr(), coeffs.data_ptr(),
            out.data_ptr(), g, heads, n, b, d, p, node_tile, d_tile, smem, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"cheb_attn kernel launch failed: CUDA error {rc} "
            f"({lib.cheb_attn_error_string(rc).decode()})"
        )
    cheb_attn.launches += 1
    return out.reshape(out_shape)


def cheb_attn(
    x: torch.Tensor, h_nb: torch.Tensor, mask: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """Fused polynomial-attention aggregation; layouts as
    :func:`~repro_torch.kernels.ref.cheb_attn_ref`.

    On CUDA every input is float32 and contiguous, ``mask`` included, and
    ``coeffs`` has at most ``MAX_COEFFS`` entries; any N, B, D and H are
    taken. Rows whose denominator is exactly zero return exact zeros.
    """
    if x.device.type == "cpu":
        return cheb_attn_ref(x, h_nb, mask, coeffs)
    return _launch(x, h_nb, mask, coeffs)


cheb_attn.launches = 0
