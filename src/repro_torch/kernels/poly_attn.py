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
sums are plain: no running max and no rescaling (design in the source).

``poly_attn`` takes :func:`poly_attn_plain` for CPU tensors and launches the
kernel for CUDA tensors, or raises. ``poly_attn.launches`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_inputs, raise_on

MAX_HEAD_DIM = 256                  # POLY_MAX_HD in csrc/poly_attn.cu
MAX_COEFFS = 64                     # POLY_MAX_COEFFS in csrc/poly_attn.cu
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("poly_attn")
        lib.poly_attn_forward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.poly_attn_forward.restype = ctypes.c_int
        lib.poly_attn_error_string.argtypes = [ctypes.c_int]
        lib.poly_attn_error_string.restype = ctypes.c_char_p
        lib.poly_attn_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        lib.poly_attn_limits.restype = None
        hd, p = ctypes.c_int(), ctypes.c_int()
        lib.poly_attn_limits(ctypes.byref(hd), ctypes.byref(p))
        if (hd.value, p.value) != (MAX_HEAD_DIM, MAX_COEFFS):
            raise RuntimeError("csrc/poly_attn.cu and poly_attn.py disagree on their limits")
        _lib = lib
    return _lib


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
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.poly_attn_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), a1.data_ptr(), a2.data_ptr(),
            coeffs.data_ptr(), out.data_ptr(), bt * heads, heads, s, hd, coeffs.numel(),
            int(causal), float(domain), _DTYPE_CODE[q.dtype], stream,
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
