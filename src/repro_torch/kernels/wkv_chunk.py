"""Chunked RWKV6 wkv recurrence with data-dependent decay: the wrapper of the
CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/wkv_chunk.py::wkv_chunked``
(``pallas_call`` at :93, body ``_wkv_kernel`` at :31) with the
hand-written Hopper kernels in ``csrc/wkv_chunk.cu``. The recurrence is

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T

computed in chunks of C tokens: with P the cumulative decay over the chunk
(clamped at 1e-24 where it divides), a = r * P_prev and k~ = k / P,

    y   = (tril(a k~^T, -1) + diag(r u . k)) v + a S_0
    S_C = diag(P_C) S_0 + ((P_C / P) * k)^T v

all in float32. ``chunk`` is part of the arithmetic (it bounds the range of
1/P), so it stays an argument; S must be a multiple of ``min(chunk, S)``.
Bound on the card: memory (r, k, v, w read once, y written once).

Two kernels, chosen by the shape (:func:`launch_plan`): the fast path
(chunk 16, hd a multiple of 16 up to 128) keeps each warp's columns of the
state in registers and runs the chunk products on the tensor cores in
3xTF32; the general path takes every other shape.

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
from repro_torch.kernels.flash_attn import _alignment

MAX_HEAD_DIM = 128                  # the general path keeps hd x hd floats in shared memory
_SMEM_MAX = 227 * 1024              # H100: most a block can opt in to
FAST_CHUNK = 16                     # the fast path's chunk
_FAST_STAGES = 3                    # its ring of chunk stages
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
        lib.wkv_chunk_fast_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.wkv_chunk_fast_forward.restype = ctypes.c_int
        lib.wkv_chunk_fast_smem.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.wkv_chunk_fast_smem.restype = ctypes.c_longlong
        lib.wkv_chunk_error_string.argtypes = [ctypes.c_int]
        lib.wkv_chunk_error_string.restype = ctypes.c_char_p
        for hd in range(16, MAX_HEAD_DIM + 1, 16):
            for dtype, code in _DTYPE_CODE.items():
                got = lib.wkv_chunk_fast_smem(hd, code)
                if got != _fast_smem(hd, dtype.itemsize):
                    raise RuntimeError(f"csrc/wkv_chunk.cu and wkv_chunk.py disagree on the "
                                       f"fast path's shared memory for hd {hd}, {dtype}: {got}")
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


def _fast_smem(hd: int, itemsize: int) -> int:
    """wkv_fast_smem_bytes of ``csrc/wkv_chunk.cu``: 128 bytes of barriers,
    then ``_FAST_STAGES`` stages of r, k, v, w as loaded (16 x hd elements
    each) and, in float32, a and k~ (16 rows of hd + 8), b (16 rows of
    hd + 4), the diagonal sums of each group of 16 channels (16 a group),
    P_C and each group's block of M (16 rows of 24)."""
    c = FAST_CHUNK
    stage = 4 * c * hd * itemsize + 4 * (2 * c * (hd + 8) + c * (hd + 4)
                                         + c * (hd // 16) + hd + (hd // 16) * c * (c + 8))
    return 128 + _FAST_STAGES * stage


def launch_plan(hd: int, c: int, dtype: torch.dtype, align: int = 16) -> dict:
    """How the kernel runs head dim ``hd`` in chunks of ``c`` when every base
    pointer of r, k, v and w is a multiple of ``align`` bytes:

    - ``path``: ``"fast"`` for ``c == FAST_CHUNK``, hd a multiple of 16 up
      to ``MAX_HEAD_DIM`` and 4-byte-aligned bases (``wkv_fast_kernel``:
      hd / 16 consumer warps with the state in registers, min(hd / 16, 4)
      decay warps and a producer warp, ``stages`` chunk stages), else
      ``"general"`` (``wkv_chunk_kernel``: 256 threads, the state in shared
      memory, one stage);
    - ``smem_bytes``: the block's dynamic shared memory;
    - ``load``: the fast path's ``"bulk"`` copies for 16-byte-aligned bases,
      else ``"cp.async"`` (4-byte copies); the general path loads with plain
      loads (``"plain"``).

    Raises ValueError for a shape no kernel takes."""
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"wkv_chunked: head dim {hd} is above the kernel's {MAX_HEAD_DIM}")
    if c == FAST_CHUNK and hd % 16 == 0 and hd >= 16 and align % 4 == 0:
        cw, dw = hd // 16, min(hd // 16, 4)
        return {"path": "fast", "chunk": c, "consumer_warps": cw, "decay_warps": dw,
                "threads": 32 * (cw + dw + 1), "stages": _FAST_STAGES,
                "smem_bytes": _fast_smem(hd, dtype.itemsize),
                "load": "bulk" if align % 16 == 0 else "cp.async"}
    smem = shared_bytes(hd, c)
    if smem > _SMEM_MAX:
        raise ValueError(f"wkv_chunked: hd={hd} with chunk={c} needs {smem} bytes of shared "
                         f"memory, above the {_SMEM_MAX} a block can have")
    return {"path": "general", "chunk": c, "threads": 256, "stages": 1, "smem_bytes": smem,
            "load": "plain"}


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


def _check_cuda(r, k, v, w, u, S0):
    """Loads the library (a kernel that cannot be built raises first), then
    raises unless r, k, v and w are contiguous CUDA tensors of one kernel
    dtype; returns the library, and u and S0 as contiguous float32."""
    lib = _library()
    u, S0 = (t.to(torch.float32).contiguous() for t in (u, S0))
    check_cuda_inputs("wkv_chunked", {"r": r, "k": k, "v": v, "w": w}, _DTYPE_CODE)
    check_cuda_inputs("wkv_chunked", {"r": r, "u": u, "S0": S0}, (r.dtype, torch.float32))
    if any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError("wkv_chunked: r, k, v and w must share one dtype, got "
                        f"{[t.dtype for t in (r, k, v, w)]}")
    return lib, u, S0


def _call(lib, entry, r, k, v, w, u, S0, *args):
    """One launch of the library's C entry ``entry(r, k, v, w, u, S0, y,
    S_out, BH, S, *args, stream)``; counts it and returns (y, S_final)."""
    bh, s, hd = r.shape
    y = torch.empty((bh, s, hd), dtype=torch.float32, device=r.device)
    s_final = torch.empty((bh, hd, hd), dtype=torch.float32, device=r.device)
    if bh == 0 or hd == 0:
        return y, s_final
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        ptrs = (t.data_ptr() for t in (r, k, v, w, u, S0, y, s_final))
        rc = getattr(lib, entry)(*ptrs, bh, s, *args, stream)
    raise_on(rc, lib.wkv_chunk_error_string, "wkv_chunked")
    wkv_chunked.launches += 1
    return y, s_final


def _launch(r, k, v, w, u, S0, chunk):
    """Launch the kernel that :func:`launch_plan` names."""
    lib, u, S0 = _check_cuda(r, k, v, w, u, S0)
    hd, c = r.shape[2], chunk_size(r.shape[1], chunk)
    plan = launch_plan(hd, c, r.dtype, _alignment(r, k, v, w))
    if plan["path"] == "general":
        return _launch_general(r, k, v, w, u, S0, c)
    return _call(lib, "wkv_chunk_fast_forward", r, k, v, w, u, S0, hd,
                 _DTYPE_CODE[r.dtype], 0 if plan["load"] == "bulk" else 1, plan["smem_bytes"])


def _launch_general(r, k, v, w, u, S0, chunk):
    """The general kernel (``wkv_chunk_kernel``) at any shape it takes, a
    fast-path shape too, where it is the second, independent kernel that
    the fast path is held against."""
    lib, u, S0 = _check_cuda(r, k, v, w, u, S0)
    hd, c = r.shape[2], chunk_size(r.shape[1], chunk)
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"wkv_chunked: head dim {hd} is above the kernel's {MAX_HEAD_DIM}")
    return _call(lib, "wkv_chunk_forward", r, k, v, w, u, S0, hd, c,
                 _DTYPE_CODE[r.dtype], shared_bytes(hd, c))


def wkv_chunked(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, S0: torch.Tensor, *, chunk: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (BH, S, hd); u: (hd,); S0: (BH, hd, hd). Returns (y: (BH, S,
    hd) float32, S_final: (BH, hd, hd) float32). S must be a multiple of
    ``min(chunk, S)`` (ValueError otherwise). On CUDA, r, k, v and w are
    contiguous and share one dtype, float32 or bfloat16; hd is at most
    ``MAX_HEAD_DIM``; u and S0 are used in float32; :func:`launch_plan` names
    the kernel. CPU tensors take :func:`wkv_chunked_plain`."""
    _check_shapes(r, k, v, w, u, S0)
    if r.device.type == "cpu":
        return wkv_chunked_plain(r, k, v, w, u, S0, chunk=chunk)
    return _launch(r, k, v, w, u, S0, chunk)


wkv_chunked.launches = 0
