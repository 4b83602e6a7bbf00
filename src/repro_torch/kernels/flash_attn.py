"""Causal softmax attention (online softmax): the wrapper of the CUDA kernel
and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attn.py::flash_attn``
(``pallas_call`` at :96, body ``_flash_kernel`` at :25) with the
hand-written Hopper kernel in ``csrc/flash_attn.cu``. What it computes:
scores ``q k^T * hd^-0.5`` in float32, causal positions above the diagonal
set to ``-1e30``, a running max, normaliser and accumulator over key tiles,
and ``out = acc / max(l, 1e-30)`` in ``q.dtype``. Its bound on the card is
the tensor-core rate for bf16 inputs and the float32 rate for float32
inputs (``chip_smoke.py`` computes both). The kernel runs both products on
the tensor cores: wgmma for bf16, mma.sync in error-compensated TF32
(3xTF32) for float32, with a producer warp feeding a ring of key and value
tiles through TMA, or through cp.async where a TMA descriptor cannot
describe the tensor. :func:`launch_plan` reports the tiles and the load
path of a call (design in the source).

``flash_attn`` takes the plain version :func:`flash_attn_plain` for CPU
tensors and launches the kernel for CUDA tensors, or raises; there is no
fallback between the two. ``flash_attn.launches`` counts launches. The
TPU's tiling knobs (``block_q``, ``block_k``, ``interpret``) are gone: the
kernel picks its own tiles and masks the ragged edge of S and hd itself,
so any S is taken.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_inputs, raise_on

NEG_INF = -1e30                     # the TPU kernel's mask value (flash_attn.py:22)
MAX_HEAD_DIM = 256                  # FLASH_MAX_HD in csrc/flash_attn.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_STAGES = 2                         # FLASH_STAGES in csrc/flash_attn.cu

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("flash_attn")
        lib.flash_attn_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.flash_attn_forward.restype = ctypes.c_int
        lib.flash_attn_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.flash_attn_plan.restype = ctypes.c_int
        lib.flash_attn_error_string.argtypes = [ctypes.c_int]
        lib.flash_attn_error_string.restype = ctypes.c_char_p
        lib.flash_attn_max_head_dim.argtypes = []
        lib.flash_attn_max_head_dim.restype = ctypes.c_int
        if lib.flash_attn_max_head_dim() != MAX_HEAD_DIM:
            raise RuntimeError("csrc/flash_attn.cu and flash_attn.py disagree on MAX_HEAD_DIM")
        for dtype, code in _DTYPE_CODE.items():
            for hd in (1, 64, 65, 128, 129, MAX_HEAD_DIM):
                got = (ctypes.c_int * 5)()
                lib.flash_attn_plan(hd, code, got)
                want = _tiles(hd, dtype)
                if tuple(got) != tuple(want[k] for k in ("hd_pad", "block_m", "block_n",
                                                         "threads", "smem_bytes")):
                    raise RuntimeError("csrc/flash_attn.cu and flash_attn.py disagree on "
                                       f"the tiles of hd={hd} {dtype}: {tuple(got)}")
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _tiles(hd: int, dtype: torch.dtype) -> dict:
    """FlashCfg of csrc/flash_attn.cu: hd padded to a multiple of the
    64-column wgmma panel; query rows per block, per consumer warp (16 for
    bf16, 32 for float32 up to hd 128: two m-tiles that share each split
    key and value fragment) and the threads (the consumer warps and a
    producer warpgroup whose registers go to the consumers); key rows per
    tile; and the shared memory of the query tile and ``_STAGES`` key and
    value tiles (plus 2 KB for the alignment and the barriers)."""
    hd_pad = 64 if hd <= 64 else 128 if hd <= 128 else 256
    bf16 = dtype == torch.bfloat16
    rows_per_warp = 32 if (not bf16 and hd_pad <= 128) else 16
    block_m = 128 if bf16 else (64 if hd_pad == 256 else 256)
    block_n = (64 if hd_pad == 256 else 128) if bf16 else (64 if hd_pad == 64 else 32)
    size = 2 if bf16 else 4
    return {
        "hd_pad": hd_pad, "block_m": block_m, "block_n": block_n,
        "rows_per_warp": rows_per_warp,
        "threads": block_m // rows_per_warp * 32 + 128,
        "smem_bytes": 2048 + (block_m + 2 * _STAGES * block_n) * hd_pad * size,
    }


def launch_plan(s: int, hd: int, dtype: torch.dtype, align: int = 16) -> dict:
    """How the kernel runs a call with sequence length ``s``, head dim
    ``hd`` and ``dtype``, when every base pointer of q, k and v is a
    multiple of ``align`` bytes: the tiles (:func:`_tiles`), the number of
    blocks per head, the products (``wgmma`` for bf16, ``mma.sync 3xTF32``
    for float32) and the load path. ``load`` is ``"tma"`` exactly when a
    TMA descriptor can describe the tensor (``hd * itemsize`` a multiple of
    16 bytes and 16-byte-aligned bases), else ``"cp.async"``, whose copies
    are 4 bytes (``copy_bytes``) unless bf16 rows are not 4-byte granular
    (odd hd or 2-byte-aligned bases), where the producer reads 2 bytes at
    a time."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attn: dtype must be float32 or bfloat16, got {dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attn: head dim {hd} is outside 1..{MAX_HEAD_DIM}")
    size = 2 if dtype == torch.bfloat16 else 4
    plan = dict(_tiles(hd, dtype))
    tma = (hd * size) % 16 == 0 and align % 16 == 0
    word = size == 4 or (hd % 2 == 0 and align % 4 == 0)
    plan.update(
        stages=_STAGES, blocks_per_head=-(-s // plan["block_m"]),
        mma="wgmma" if dtype == torch.bfloat16 else "mma.sync 3xTF32",
        load="tma" if tma else "cp.async", copy_bytes=None if tma else (4 if word else 2),
    )
    return plan


def _alignment(*tensors) -> int:
    """The largest power of two, at most 16, dividing every base pointer."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


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
    plan = launch_plan(s, hd, q.dtype, _alignment(q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attn_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bt * heads, s, hd, int(causal), _DTYPE_CODE[q.dtype], hd**-0.5,
            int(plan["load"] == "tma"), int(plan["copy_bytes"] == 4), stream,
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
