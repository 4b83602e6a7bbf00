"""Fused polynomial-attention aggregation: the wrappers of the CUDA kernels.

Replaces the Pallas TPU kernel ``repro/kernels/cheb_attn.py::cheb_attn``
(``pallas_call`` at :146) and the backward of its differentiable entry
``cheb_attn_diff`` (:161, backward at :189) with the hand-written Hopper
kernels in ``csrc/cheb_attn.cu``. The forward kernel is bound by memory
(it reads the scores, the neighbour features and the mask once and writes
the output once; ~2.1 GB, ~0.63 ms at 3.35 TB/s for the sbm_1m serving
shape). Its design: a persistent grid of one wave walks tiles of
consecutive nodes; a producer warp per block keeps a ring of two stages
in shared memory filled by 1-D bulk copies (each tile's score segments,
neighbour span and mask span), or by cp.async where a bulk copy cannot
take them, while consumer warps compute one node at a time, every head
inside the block, so each neighbour tile is read from device memory once
for all heads. :func:`launch_plan` gives the tile, the warps, the shared
memory and the load path of a call. The backward kernel recomputes the
weights and denominators instead of saving them, one warp per node in a
grid-stride
loop: each node's scores, neighbour tile and dout are read from device
memory once into the warp's slice of shared memory, and the cotangent of
the weights is factored into two small products so that the output is
never formed (~2.6 GB, ~0.78 ms at the sbm_1m training shape when only
``dx`` is asked for).

:func:`cheb_attn` is a ``torch.autograd.Function``. CPU tensors take the
plain versions (:func:`~repro_torch.kernels.ref.cheb_attn_ref` forward,
:func:`~repro_torch.kernels.ref.cheb_attn_bwd_ref` backward); CUDA tensors
launch the kernels or raise. There is no fallback between the two.
``cheb_attn.launches`` and ``cheb_attn_backward.launches`` count launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_inputs, raise_on
from repro_torch.kernels.ref import cheb_attn_bwd_ref, cheb_attn_ref

MAX_COEFFS = 64                     # CHEB_MAX_COEFFS in csrc/cheb_attn.cu
_FWD_MAX_WARPS = 8                  # FWD_MAX_WARPS in csrc/cheb_attn.cu
_FWD_STAGES = 2                     # FWD_STAGES in csrc/cheb_attn.cu
_FWD_STAGE_BUDGET = 32 * 1024       # a stage's bytes, so that three blocks fit an SM
_BWD_MAX_WARPS = 8                  # BWD_MAX_WARPS in csrc/cheb_attn.cu
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
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p,
        ]
        lib.cheb_attn_forward.restype = ctypes.c_int
        lib.cheb_attn_fwd_smem.argtypes = [ctypes.c_int] * 5
        lib.cheb_attn_fwd_smem.restype = ctypes.c_longlong
        lib.cheb_attn_fwd_max_warps.argtypes = []
        lib.cheb_attn_fwd_max_warps.restype = ctypes.c_int
        lib.cheb_attn_fwd_blocks_per_sm.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
        ]
        lib.cheb_attn_fwd_blocks_per_sm.restype = ctypes.c_int
        lib.cheb_attn_backward.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.cheb_attn_backward.restype = ctypes.c_int
        lib.cheb_attn_bwd_blocks_per_sm.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.cheb_attn_bwd_blocks_per_sm.restype = ctypes.c_int
        lib.cheb_attn_bwd_max_warps.argtypes = []
        lib.cheb_attn_bwd_max_warps.restype = ctypes.c_int
        lib.cheb_attn_error_string.argtypes = [ctypes.c_int]
        lib.cheb_attn_error_string.restype = ctypes.c_char_p
        lib.cheb_attn_max_coeffs.argtypes = []
        lib.cheb_attn_max_coeffs.restype = ctypes.c_int
        if lib.cheb_attn_max_coeffs() != MAX_COEFFS:
            raise RuntimeError("csrc/cheb_attn.cu and cheb_attn.py disagree on MAX_COEFFS")
        if lib.cheb_attn_bwd_max_warps() != _BWD_MAX_WARPS:
            raise RuntimeError("csrc/cheb_attn.cu and cheb_attn.py disagree on BWD_MAX_WARPS")
        if lib.cheb_attn_fwd_max_warps() != _FWD_MAX_WARPS:
            raise RuntimeError("csrc/cheb_attn.cu and cheb_attn.py disagree on FWD_MAX_WARPS")
        for shape in ((8, 16, 16), (8, 8, 16), (3, 5, 300), (1, 8, 1), (16, 64, 128)):
            plan = launch_plan(*shape, aligned=True)
            got = lib.cheb_attn_fwd_smem(shape[0], shape[1], plan["tile"], plan["d_chunk"],
                                         plan["warps"])
            if got != plan["smem_bytes"]:
                raise RuntimeError(f"csrc/cheb_attn.cu and cheb_attn.py disagree on the "
                                   f"forward's shared memory for H, B, D = {shape}: {got}")
        _lib = lib
    return _lib


def _r4(n: int) -> int:
    return -(-n // 4) * 4


def _fwd_smem(heads: int, b: int, tile: int, d_chunk: int, warps: int) -> int:
    """fwd_smem_bytes of csrc/cheb_attn.cu: 128 bytes of barriers, the
    coefficients, each consumer warp's weights (H rows at the odd stride
    B | 1) and denominators, and ``_FWD_STAGES`` stages of :func:`_fwd_stage`."""
    return (128 + 4 * MAX_COEFFS + 4 * warps * (_r4(heads * (b | 1)) + _r4(heads))
            + _FWD_STAGES * _fwd_stage(heads, b, tile, d_chunk))


def _fwd_stage(heads: int, b: int, tile: int, d_chunk: int) -> int:
    """Bytes of one forward stage: H score segments of ``tile * b`` floats at
    a stride of ``tile + 1`` node rows (rounded to 16 bytes), the mask span
    and ``tile * b`` neighbour rows of ``d_chunk`` floats."""
    return 4 * (heads * _r4((tile + 1) * b) + _r4(tile * b) + _r4(tile * b * d_chunk))


def launch_plan(heads: int, b: int, d: int, aligned: bool) -> dict:
    """How the forward kernel runs H = ``heads``, B = ``b``, D = ``d``:

    - ``tile``: nodes per stage, the largest power of two up to 32 whose
      stage fits ``_FWD_STAGE_BUDGET`` (so that three blocks share an SM), at
      least 1; ``warps``: consumer warps, ``min(8, tile)``, plus one
      producer warp (``threads``);
    - ``d_chunk``: D, unless one node's stage is too large for the 227 KB a
      block can have; then the widest chunk of columns that fits (a
      multiple of 4 when at least 4). A row too large even for one column
      raises ``ValueError``;
    - ``stages`` and ``smem_bytes``, the size formula of ``fwd_smem_bytes``
      in ``csrc/cheb_attn.cu``;
    - ``load``: ``"tma"`` (1-D bulk copies, ``cp.async.bulk``) when
      ``aligned`` (the base pointers of x, h_nb and mask are 16-byte
      multiples), B is a multiple of 4 and D is one chunk, else
      ``"cp.async"``.
    """
    return dict(_plan(heads, b, d, bool(aligned)))


@functools.lru_cache(maxsize=None)
def _plan(heads: int, b: int, d: int, aligned: bool) -> dict:
    tile = 32
    while tile > 1 and _fwd_stage(heads, b, tile, d) > _FWD_STAGE_BUDGET:
        tile //= 2
    warps = min(_FWD_MAX_WARPS, tile)
    d_chunk = d
    if _fwd_smem(heads, b, tile, d, warps) > _SMEM_MAX:
        # A column adds 8 B bytes over the two stages, and rounding at most 16.
        d_chunk = (_SMEM_MAX - _fwd_smem(heads, b, 1, 0, 1)) // (8 * b)
        while d_chunk > 0 and _fwd_smem(heads, b, 1, d_chunk, 1) > _SMEM_MAX:
            d_chunk -= 1
        if d_chunk < 1:
            raise ValueError(
                f"cheb_attn: H*B = {heads}*{b} needs {_fwd_smem(heads, b, 1, 1, 1)} bytes of "
                f"shared memory for one node, above the {_SMEM_MAX} a block can have"
            )
        d_chunk -= d_chunk % 4 if d_chunk >= 4 else 0
    smem = _fwd_smem(heads, b, tile, d_chunk, warps)
    tma = aligned and b % 4 == 0 and d_chunk == d
    return {"tile": tile, "d_chunk": d_chunk, "warps": warps, "threads": 32 * (warps + 1),
            "stages": _FWD_STAGES, "smem_bytes": smem, "load": "tma" if tma else "cp.async"}


def _bwd_ld(dc: int) -> int:
    """Row stride of a staged chunk (bwd_ld in csrc/cheb_attn.cu): a
    multiple of 4 floats whose quarter is odd when ``dc`` is a multiple of
    4 (16-byte rows, 8 lanes' rows in distinct banks), else odd."""
    if dc % 4:
        return dc | 1
    q = dc // 4 + 1
    return 4 * (q + 1 - (q & 1))


@functools.lru_cache(maxsize=None)
def backward_launch_config(heads: int, b: int, d: int) -> Tuple[int, int, int]:
    """``(warps, d_chunk, smem_bytes)`` for one backward launch.

    Each warp owns one node at a time and stages it in its own slice of
    shared memory: the scores, the mask row and ``d_chunk`` columns of the
    neighbour tile and of dout (rows at stride :func:`_bwd_ld`); then p,
    p', the weights and the products ``A`` (4 H*B floats) and two
    H-vectors, every array rounded up to 4 floats; besides, ``MAX_COEFFS``
    floats for its dcoeffs partial, and the block the coefficients.
    ``d_chunk`` is D when the slice fits the default 48 KB of a block, else
    the widest chunk that does (a multiple of 32 when at least 32); a slice
    that does not fit even one column opts in to the 227 KB a block can
    have, and a larger one raises. ``warps`` fills the block, at most
    ``_BWD_MAX_WARPS``. The size formula matches the slice layout of
    ``cheb_attn_bwd_kernel`` in ``csrc/cheb_attn.cu``.
    """
    fixed = 4 * MAX_COEFFS

    def per_warp(dc):
        ld = _bwd_ld(dc)
        floats = 5 * _r4(heads * b) + _r4(b) + _r4(b * ld) + _r4(heads * ld) + 2 * _r4(heads)
        return 4 * (floats + MAX_COEFFS)

    budget = _SMEM_DEFAULT if fixed + per_warp(1) <= _SMEM_DEFAULT else _SMEM_MAX
    if fixed + per_warp(1) > budget:
        raise ValueError(
            f"cheb_attn backward: H={heads}, B={b}, D={d} needs {fixed + per_warp(1)} bytes "
            f"of shared memory for one node, above the {_SMEM_MAX} a block can have"
        )
    d_chunk = max(d, 1)
    if fixed + per_warp(d_chunk) > budget:
        d_chunk = max(c for c in range(1, d + 1) if fixed + per_warp(c) <= budget)
        if d_chunk >= 32:
            d_chunk -= d_chunk % 32
    warps = max(1, min(_BWD_MAX_WARPS, (budget - fixed) // per_warp(d_chunk)))
    return warps, d_chunk, fixed + warps * per_warp(d_chunk)


def wave_grid(items: int, per_block: int, blocks_per_sm: int, sm_count: int) -> int:
    """Blocks of a grid-stride loop over ``items`` that takes ``per_block``
    of them per block at a time (the backward's nodes, a warp each; the
    forward's node tiles, one at a time): one wave of the blocks that fit
    on the card at once (``blocks_per_sm``, from the CUDA occupancy query
    of the kernel instance), fewer when there are fewer items. More blocks
    than fit would run in a second, partial wave after the first."""
    return max(1, min(-(-items // per_block), sm_count * max(1, blocks_per_sm)))


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


def _check_coeffs(coeffs):
    p = coeffs.numel()
    if coeffs.dim() != 1 or not 1 <= p <= MAX_COEFFS:
        raise ValueError(f"cheb_attn: coeffs must be 1-D with 1..{MAX_COEFFS} "
                         f"entries, got shape {tuple(coeffs.shape)}")
    return p


def _launch(x, h_nb, mask, coeffs):
    lib = _library()
    out_shape = x.shape[:-1] + h_nb.shape[-1:]
    x4, h4, m4 = _batched(x, h_nb, mask)
    check_cuda_inputs("cheb_attn", {"x": x4, "h_nb": h4, "mask": m4, "coeffs": coeffs},
                      (torch.float32,))
    p = _check_coeffs(coeffs)
    g, heads, n, b = x4.shape
    d = h4.shape[-1]
    out = torch.empty((g, heads, n, d), dtype=torch.float32, device=x.device)
    if out.numel() == 0 or b == 0:              # no neighbours: every denominator is 0
        return out.zero_().reshape(out_shape)
    aligned = _aligned(x4, h4, m4)
    plan = launch_plan(heads, b, d, aligned)
    tile, d_chunk, warps, smem = plan["tile"], plan["d_chunk"], plan["warps"], plan["smem_bytes"]
    sm_count, per_sm = _occupancy(x.device.index, "cheb_attn_fwd_blocks_per_sm", b, warps, smem)
    grid = wave_grid(g * -(-n // tile) * -(-d // d_chunk), 1, per_sm, sm_count)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.cheb_attn_forward(
            x4.data_ptr(), h4.data_ptr(), m4.data_ptr(), coeffs.data_ptr(),
            out.data_ptr(), g, heads, n, b, d, p, tile, d_chunk, warps, grid,
            int(plan["load"] == "tma"), int(aligned and d % 4 == 0 and d_chunk % 4 == 0),
            smem, stream,
        )
    raise_on(rc, lib.cheb_attn_error_string, "cheb_attn")
    cheb_attn.launches += 1
    return out.reshape(out_shape)


@functools.lru_cache(maxsize=None)
def _occupancy(device: int, query: str, *args: int) -> Tuple[int, int]:
    """(SMs of the card, blocks that fit on one SM) from the library's
    occupancy ``query`` (``cheb_attn_fwd_blocks_per_sm`` or
    ``cheb_attn_bwd_blocks_per_sm``) with ``args``, asked once per launch
    shape: the query costs more host time than a launch."""
    lib = _library()
    per_sm = ctypes.c_int(0)
    with torch.cuda.device(device):
        raise_on(getattr(lib, query)(*args, ctypes.byref(per_sm)),
                 lib.cheb_attn_error_string, f"cheb_attn occupancy ({query})")
    return torch.cuda.get_device_properties(device).multi_processor_count, per_sm.value


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_backward(x, h_nb, mask, coeffs, dout, needs):
    lib = _library()
    x4, h4, m4 = _batched(x, h_nb, mask)
    g, heads, n, b = x4.shape
    d = h4.shape[-1]
    if tuple(dout.shape) != tuple(x.shape[:-1] + h_nb.shape[-1:]):
        raise ValueError(f"cheb_attn backward: dout has shape {tuple(dout.shape)}, "
                         f"the forward's output {tuple(x.shape[:-1] + h_nb.shape[-1:])}")
    d4 = dout.reshape(g, heads, n, d)
    check_cuda_inputs("cheb_attn backward",
                      {"x": x4, "h_nb": h4, "mask": m4, "coeffs": coeffs, "dout": d4},
                      (torch.float32,))
    p = _check_coeffs(coeffs)
    warps, d_chunk, smem = backward_launch_config(heads, b, d)
    sm_count, per_sm = _occupancy(x.device.index, "cheb_attn_bwd_blocks_per_sm", p,
                                  int(bool(needs[3])), warps, smem)
    grid = wave_grid(g * n, warps, per_sm, sm_count)

    def empty(shape, want):              # the kernel writes every entry
        return torch.empty(shape, dtype=torch.float32, device=x.device) if want else None

    dx, dh, dm = empty(x4.shape, needs[0]), empty(h4.shape, needs[1]), empty(m4.shape, needs[2])
    dq_part = empty((grid, p), needs[3])
    if x4.numel() and any(needs):
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = lib.cheb_attn_backward(
                x4.data_ptr(), h4.data_ptr(), m4.data_ptr(), coeffs.data_ptr(), d4.data_ptr(),
                *(t.data_ptr() if t is not None else None for t in (dx, dh, dm, dq_part)),
                g, heads, n, b, d, p, warps, d_chunk, grid,
                int(b % 4 == 0 and _aligned(x4, m4)),
                int(d > 0 and d % 4 == 0 and (d_chunk == d or d_chunk % 4 == 0)
                    and _aligned(h4, d4)),
                smem, stream,
            )
        raise_on(rc, lib.cheb_attn_error_string, "cheb_attn backward")
        cheb_attn_backward.launches += 1
    return (
        None if dx is None else dx.reshape(x.shape),
        None if dh is None else dh.reshape(h_nb.shape),
        None if dm is None else dm.reshape(mask.shape),
        None if dq_part is None else dq_part.sum(0),
    )


def cheb_attn_backward(x, h_nb, mask, coeffs, dout, needs=(True, True, True, True)):
    """Cotangents ``(dx, dh_nb, dmask, dcoeffs)`` of :func:`cheb_attn` given
    ``dout``; those with a false entry in ``needs`` are ``None`` and are not
    computed (the kernel takes null pointers for them). CPU tensors take
    :func:`~repro_torch.kernels.ref.cheb_attn_bwd_ref`; CUDA tensors launch
    the backward kernel or raise. ``dcoeffs`` sums per-block partials in a
    second pass, so it does not depend on the order blocks run in."""
    if x.device.type == "cpu":
        return cheb_attn_bwd_ref(x, h_nb, mask, coeffs, dout, needs)
    return _launch_backward(x, h_nb, mask, coeffs, dout.contiguous(), needs)


class _ChebAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h_nb, mask, coeffs):
        ctx.save_for_backward(x, h_nb, mask, coeffs)
        if x.device.type == "cpu":
            return cheb_attn_ref(x, h_nb, mask, coeffs)
        return _launch(x, h_nb, mask, coeffs)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        return cheb_attn_backward(*ctx.saved_tensors, dout, ctx.needs_input_grad)


def cheb_attn(
    x: torch.Tensor, h_nb: torch.Tensor, mask: torch.Tensor, coeffs: torch.Tensor
) -> torch.Tensor:
    """Fused polynomial-attention aggregation; layouts as
    :func:`~repro_torch.kernels.ref.cheb_attn_ref`. Differentiable in all
    four inputs, once: the backward is :func:`cheb_attn_backward` (a kernel
    on CUDA), marked ``once_differentiable`` because nothing in the repo
    takes a second derivative, although the reference's backward could be
    differentiated again.

    On CUDA every input is float32 and contiguous, ``mask`` included, and
    ``coeffs`` has at most ``MAX_COEFFS`` entries; any N, B, D and H are
    taken. Rows whose denominator is exactly zero return exact zeros, and
    their cotangents are exact zeros.
    """
    return _ChebAttn.apply(x, h_nb, mask, torch.as_tensor(coeffs, device=x.device))


cheb_attn.launches = 0
cheb_attn_backward.launches = 0
