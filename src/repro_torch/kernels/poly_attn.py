"""Additive polynomial attention (FedGAT's score on sequences): the wrapper of
the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel ``repro/kernels/poly_attn.py::poly_attn``
(``pallas_call`` at :99, body ``_poly_kernel`` at :25) with the
hand-written Hopper kernel in ``csrc/poly_attn.cu``. What it computes, in
float32: ``x_ij = clip(a1.q_i + a2.k_j, -domain, domain)``, ``e = Horner(
coeffs, x)``, zero above the diagonal when causal, and ``out = sum_j e v_j /
guard(sum_j e)`` in ``q.dtype``, where the guard is the TPU kernel's
``where(|den| < 1e-9, 1e-9, den)`` (poly_attn.py:66): a negative
denominator divides. The oracle ``repro/kernels/ref.py::poly_attn_ref``
guards with ``maximum(den, 1e-9)`` instead and disagrees on such rows; the
port follows the kernel (``ref.poly_attn_ref`` keeps the oracle's guard).

Bound on the card: float32 operations (Horner per score and the ``e . v``
sums). The scores are rank one, so there is no ``q k^T`` product, and the
sums are plain: no running max and no rescaling. The kernel runs ``e . v``
on the tensor cores (wgmma with ``e`` as a bf16 pair for bf16 inputs,
mma.sync in error-compensated TF32 for float32), fed by a producer warp
that keeps a ring of key and value tiles through TMA, or through cp.async
where a TMA descriptor cannot describe the tensor; :func:`launch_plan`
reports the tiles and the load path of a call (design in the source).

``poly_attn`` takes :func:`poly_attn_plain` for CPU tensors and launches the
kernel for CUDA tensors, or raises. ``poly_attn.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_inputs, raise_on
from repro_torch.kernels.flash_attn import _alignment

MAX_HEAD_DIM = 256                  # POLY_MAX_HD in csrc/poly_attn.cu
MAX_COEFFS = 64                     # POLY_MAX_COEFFS in csrc/poly_attn.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_MAX = 227 * 1024              # POLY_SMEM_MAX in csrc/poly_attn.cu
_FIXED = 4096                       # PolyCfg::FIXED: alignment, barriers, coeffs, sk, a2

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("poly_attn")
        lib.poly_attn_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.poly_attn_forward.restype = ctypes.c_int
        lib.poly_attn_plan.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.poly_attn_plan.restype = ctypes.c_int
        lib.poly_attn_error_string.argtypes = [ctypes.c_int]
        lib.poly_attn_error_string.restype = ctypes.c_char_p
        lib.poly_attn_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.poly_attn_limits.restype = None
        hd, p = ctypes.c_int(), ctypes.c_int()
        lib.poly_attn_limits(ctypes.byref(hd), ctypes.byref(p))
        if (hd.value, p.value) != (MAX_HEAD_DIM, MAX_COEFFS):
            raise RuntimeError("csrc/poly_attn.cu and poly_attn.py disagree on their limits")
        for dtype, code in _DTYPE_CODE.items():
            for hd in (1, 64, 65, 128, 129, MAX_HEAD_DIM):
                got = (ctypes.c_int * 6)()
                lib.poly_attn_plan(hd, code, got)
                want = _tiles(hd, dtype)
                if tuple(got) != tuple(want[k] for k in ("hd_pad", "block_m", "block_n",
                                                         "threads", "smem_bytes", "stages")):
                    raise RuntimeError("csrc/poly_attn.cu and poly_attn.py disagree on "
                                       f"the tiles of hd={hd} {dtype}: {tuple(got)}")
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _tiles(hd: int, dtype: torch.dtype) -> dict:
    """PolyCfg of csrc/poly_attn.cu: hd padded to a multiple of the 64-column
    wgmma panel; 8 consumer warps of 16 query rows per m-tile, one m-tile
    for bf16 (two warpgroups, 128 rows) and two for float32 up to hd 128
    (each split value fragment feeds both: 256 rows), plus a producer
    warpgroup (a loading warp and the warp that computes sk); keys per
    tile; and as many stages of a key and a value tile as fit the 227 KB a
    block can have, at most 4, beside 4 KB for the alignment, the
    barriers, the coefficients, sk and a2."""
    hd_pad = 64 if hd <= 64 else 128 if hd <= 128 else 256
    bf16 = dtype == torch.bfloat16
    rows_per_warp = 32 if (not bf16 and hd_pad <= 128) else 16
    block_n = 64 if (bf16 and hd_pad <= 128) else 32
    stage = 2 * block_n * hd_pad * (2 if bf16 else 4)
    stages = min(4, (_SMEM_MAX - _FIXED) // stage)
    return {
        "hd_pad": hd_pad, "block_m": 8 * rows_per_warp, "block_n": block_n,
        "rows_per_warp": rows_per_warp, "threads": 8 * 32 + 128,
        "smem_bytes": _FIXED + stages * stage, "stages": stages,
    }


def launch_plan(s: int, hd: int, dtype: torch.dtype, align: int = 16) -> dict:
    """How the kernel runs a call with sequence length ``s``, head dim ``hd``
    and ``dtype``, when the base pointers of k and v are multiples of
    ``align`` bytes: the tiles (:func:`_tiles`), the blocks per head, the
    product (``wgmma`` with ``e`` as a bf16 pair for bf16, ``mma.sync
    3xTF32`` for float32) and the load path of the key and value tiles:
    ``"tma"`` exactly when a TMA descriptor can describe them (``hd *
    itemsize`` a multiple of 16 bytes and 16-byte-aligned bases), else
    ``"cp.async"``, whose copies are 4 bytes (``copy_bytes``) unless bf16
    rows are not 4-byte granular (odd hd or 2-byte-aligned bases)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"poly_attn: dtype must be float32 or bfloat16, got {dtype}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"poly_attn: head dim {hd} is outside 1..{MAX_HEAD_DIM}")
    size = 2 if dtype == torch.bfloat16 else 4
    plan = dict(_tiles(hd, dtype))
    tma = (hd * size) % 16 == 0 and align % 16 == 0
    word = size == 4 or (hd % 2 == 0 and align % 4 == 0)
    plan.update(
        blocks_per_head=-(-s // plan["block_m"]),
        mma="wgmma bf16 pair" if dtype == torch.bfloat16 else "mma.sync 3xTF32",
        load="tma" if tma else "cp.async", copy_bytes=None if tma else (4 if word else 2),
    )
    return plan


def _check_shapes(q, k, v, a1, a2, coeffs):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "poly_attn: q, k and v must be (B, H, S, hd) of one shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    want = (q.shape[1], q.shape[3])
    if tuple(a1.shape) != want or tuple(a2.shape) != want:
        raise ValueError(f"poly_attn: a1 and a2 must be (H, hd) = {want}; got "
                         f"{tuple(a1.shape)}, {tuple(a2.shape)}")
    if coeffs.dim() != 1 or coeffs.numel() < 1:
        raise ValueError(f"poly_attn: coeffs must be 1-D and non-empty, got {tuple(coeffs.shape)}")


def poly_attn_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, a1: torch.Tensor,
    a2: torch.Tensor, coeffs: torch.Tensor, *, causal: bool = True, domain: float = 4.0,
) -> torch.Tensor:
    """What the TPU kernel computes, over whole rows: the rank-one clipped
    scores, Horner from the highest coefficient, zero above the diagonal
    when causal, and the ``where(|den| < 1e-9, 1e-9, den)`` guard. Returns
    ``q.dtype``."""
    coeffs = torch.as_tensor(coeffs, dtype=torch.float32, device=q.device)
    sq = (q.float() * a1.float()[None, :, None, :]).sum(-1)          # (B, H, S)
    sk = (k.float() * a2.float()[None, :, None, :]).sum(-1)
    x = (sq[..., :, None] + sk[..., None, :]).clamp_(-domain, domain)
    e = torch.zeros_like(x)
    for qn in coeffs.flip(0):
        e.mul_(x).add_(qn)                                             # Horner
    del x
    if causal:
        n = q.shape[2]
        e.masked_fill_(torch.ones((n, n), dtype=torch.bool, device=q.device).triu_(1), 0.0)
    num = torch.einsum("bhqk,bhkd->bhqd", e, v.float())
    den = e.sum(dim=-1, keepdim=True)
    den = torch.where(den.abs() < 1e-9, 1e-9, den)
    return (num / den).to(q.dtype)


def _launch(q, k, v, a1, a2, coeffs, causal, domain):
    lib = _library()
    a1, a2, coeffs = (t.to(torch.float32).contiguous() for t in (a1, a2, coeffs))
    check_cuda_inputs("poly_attn", {"q": q, "k": k, "v": v}, _DTYPE_CODE)
    check_cuda_inputs("poly_attn", {"q": q, "a1": a1, "a2": a2, "coeffs": coeffs},
                      (q.dtype, torch.float32))
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"poly_attn: q, k and v must share one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    bt, heads, s, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"poly_attn: head dim {hd} is above the kernel's {MAX_HEAD_DIM}")
    if coeffs.numel() > MAX_COEFFS:
        raise ValueError(f"poly_attn: {coeffs.numel()} coefficients, above the kernel's "
                         f"{MAX_COEFFS}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan = launch_plan(s, hd, q.dtype, _alignment(k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.poly_attn_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), a1.data_ptr(), a2.data_ptr(),
            coeffs.data_ptr(), out.data_ptr(), bt * heads, heads, s, hd, coeffs.numel(),
            int(causal), float(domain), _DTYPE_CODE[q.dtype], int(plan["load"] == "tma"),
            int(plan["copy_bytes"] == 4), stream,
        )
    raise_on(rc, lib.poly_attn_error_string, "poly_attn")
    poly_attn.launches += 1
    return out


def poly_attn(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, a1: torch.Tensor,
    a2: torch.Tensor, coeffs, *, causal: bool = True, domain: float = 4.0,
) -> torch.Tensor:
    """q/k/v: (B, H, S, hd); a1/a2: (H, hd); coeffs: (p+1,) -> (B, H, S, hd)
    in ``q.dtype``. On CUDA, q, k and v are contiguous and share one dtype,
    float32 or bfloat16; hd is at most ``MAX_HEAD_DIM`` and p+1 at most
    ``MAX_COEFFS``; any S is taken. a1, a2 and coeffs are used in float32.
    CPU tensors take :func:`poly_attn_plain`."""
    coeffs = torch.as_tensor(coeffs, device=q.device)
    _check_shapes(q, k, v, a1, a2, coeffs)
    if q.device.type == "cpu":
        return poly_attn_plain(q, k, v, a1, a2, coeffs, causal=causal, domain=domain)
    return _launch(q, k, v, a1, a2, coeffs, causal, domain)


poly_attn.launches = 0
