"""Chunked RWKV6 wkv recurrence with data-dependent decay: the wrapper of the
CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/wkv_chunk.py::wkv_chunked``
(``pallas_call`` at :93, body ``_wkv_kernel`` at :29) with the
hand-written Hopper kernel in ``csrc/wkv_chunk.cu``. The recurrence is

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

computed in chunks of C tokens: with P the cumulative decay over the chunk
(clamped at 1e-24 where it divides), a = r * P_prev and k~ = k / P,

    y   = (tril(a k~^T, -1) + diag(r u . k)) v + a S_0
    S_C = diag(P_C) S_0 + ((P_C / P) * k)^T v

all in float32. ``chunk`` is part of the arithmetic (it bounds the range of
1/P), so it stays an argument; S must be a multiple of ``min(chunk, S)``.
Bound on the card: memory (r, k, v, w read once, y written once).

``wkv_chunked`` takes :func:`wkv_chunked_plain` for CPU tensors and launches
the kernel for CUDA tensors, or raises. ``wkv_chunked.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_inputs, raise_on

MAX_HEAD_DIM = 128                  # the state (hd x hd float32) lives in shared memory
_SMEM_MAX = 227 * 1024              # H100: most a block can opt in to
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("wkv_chunk")
        lib.wkv_chunk_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.wkv_chunk_forward.restype = ctypes.c_int
        lib.wkv_chunk_error_string.argtypes = [ctypes.c_int]
        lib.wkv_chunk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def chunk_size(s: int, chunk: int) -> int:
    """``min(chunk, s)``, the chunk the recurrence runs in; raises unless it
    divides ``s``, as the reference does."""
    c = min(chunk, s)
    if c < 1 or s % c:
        raise ValueError(f"S={s} must be a multiple of chunk={c}")
    return c


def shared_bytes(hd: int, c: int) -> int:
    """Dynamic shared memory of one block: the hd x hd state, u, seven C x
    (hd | 1) chunk arrays and the C x (C + 1) matrix. Matches the layout in
    ``csrc/wkv_chunk.cu``."""
    return 4 * (hd * hd + hd + 7 * c * (hd | 1) + c * (c + 1))


def _check_shapes(r, k, v, w, u, S0):
    if r.dim() != 3 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError("wkv_chunked: r, k, v and w must be (BH, S, hd) of one shape; got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    bh, _, hd = r.shape
    if tuple(u.shape) != (hd,) or tuple(S0.shape) != (bh, hd, hd):
        raise ValueError(f"wkv_chunked: u must be ({hd},) and S0 ({bh}, {hd}, {hd}); got "
                         f"{tuple(u.shape)}, {tuple(S0.shape)}")


def wkv_chunked_plain(r, k, v, w, u, S0, *, chunk: int = 16):
    """The TPU kernel's chunked formulation in batched matrix ops over all
    chunks at once, with the same clamps; only the chunk-to-chunk state
    ``S_C = diag(P_C) S_0 + kv_C`` runs as a loop. Returns (y, S_final),
    float32."""
    bh, s, hd = r.shape
    c = chunk_size(s, chunk)
    n = s // c
    rf, kf, vf, wf = (t.float().reshape(bh, n, c, hd) for t in (r, k, v, w))
    P = torch.cumprod(wf, dim=2)                                   # (BH, n, C, hd)
    P_prev = torch.cat([torch.ones_like(P[:, :, :1]), P[:, :, :-1]], dim=2)
    a = rf * P_prev
    kt = kf / P.clamp_min(1e-24)
    scores = a @ kt.transpose(-1, -2)                              # (BH, n, C, C)
    t = torch.arange(c, device=r.device)
    diag = (rf * u.float() * kf).sum(-1)                           # bonus term
    M = torch.where(t[:, None] > t[None, :], scores, 0.0)
    M = M + torch.where(t[:, None] == t[None, :], diag[..., None], 0.0)
    b = (P[:, :, -1:, :] / P.clamp_min(1e-24)) * kf
    kv = b.transpose(-1, -2) @ vf                                  # (BH, n, hd, hd)
    decay = P[:, :, -1, :, None]                                   # diag(P_C)
    state = S0.float()
    states = []
    for i in range(n):
        states.append(state)
        state = decay[:, i] * state + kv[:, i]
    y = M @ vf + a @ torch.stack(states, dim=1)
    return y.reshape(bh, s, hd), state


def _launch(r, k, v, w, u, S0, chunk):
    lib = _library()
    u, S0 = (t.to(torch.float32).contiguous() for t in (u, S0))
    check_cuda_inputs("wkv_chunked", {"r": r, "k": k, "v": v, "w": w}, _DTYPE_CODE)
    check_cuda_inputs("wkv_chunked", {"r": r, "u": u, "S0": S0}, (r.dtype, torch.float32))
    if any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError("wkv_chunked: r, k, v and w must share one dtype, got "
                        f"{[t.dtype for t in (r, k, v, w)]}")
    bh, s, hd = r.shape
    c = chunk_size(s, chunk)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"wkv_chunked: head dim {hd} is above the kernel's {MAX_HEAD_DIM}")
    smem = shared_bytes(hd, c)
    if smem > _SMEM_MAX:
        raise ValueError(f"wkv_chunked: hd={hd} with chunk={c} needs {smem} bytes of shared "
                         f"memory, above the {_SMEM_MAX} a block can have")
    y = torch.empty((bh, s, hd), dtype=torch.float32, device=r.device)
    s_final = torch.empty((bh, hd, hd), dtype=torch.float32, device=r.device)
    if bh == 0 or hd == 0:
        return y, s_final
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.wkv_chunk_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            S0.data_ptr(), y.data_ptr(), s_final.data_ptr(), bh, s, hd, c,
            _DTYPE_CODE[r.dtype], smem, stream,
        )
    raise_on(rc, lib.wkv_chunk_error_string, "wkv_chunked")
    wkv_chunked.launches += 1
    return y, s_final


def wkv_chunked(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, S0: torch.Tensor, *, chunk: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (BH, S, hd); u: (hd,); S0: (BH, hd, hd). Returns (y: (BH, S,
    hd) float32, S_final: (BH, hd, hd) float32). S must be a multiple of
    ``min(chunk, S)`` (ValueError otherwise). On CUDA, r, k, v and w are
    contiguous and share one dtype, float32 or bfloat16; hd is at most
    ``MAX_HEAD_DIM``; u and S0 are used in float32. CPU tensors take
    :func:`wkv_chunked_plain`."""
    _check_shapes(r, k, v, w, u, S0)
    if r.device.type == "cpu":
        return wkv_chunked_plain(r, k, v, w, u, S0, chunk=chunk)
    return _launch(r, k, v, w, u, S0, chunk)


wkv_chunked.launches = 0
