"""The neighbour gather ``x[:, nbr_idx, :]`` with a CUDA backward.

The local step gathers per-node rows over padded neighbour lists (the
scores ``s2`` and the projected features ``z`` of ``core/gat.py``, the
scores of ``core/poly_attention.py::edge_scores``). The backward of plain
indexing is PyTorch's ``index_put_`` with accumulate, which walks each run
of equal indices in one warp; padding points every empty slot at node 0,
so one warp walks about half of all slots. :func:`nbr_gather` keeps the
forward (PyTorch's gather) and takes its backward to the hand-written
kernel in ``csrc/nbr_gather.cu``: a stable sort of the slots by index (the
plan, :func:`gather_plan`, built in the backward and freed after it), then
a segmented sum over fixed-size chunks of the sorted slots, whose partial
sums at chunk edges fold in further levels of the same kernel. It replaces
no TPU kernel (the reference's gather backward is XLA's scatter-add), is
bound by bytes (the cotangent read once, dx written once), uses no atomics
and gives the same bits on every run.

CPU tensors, and tensors that need no gradient, take plain indexing. CUDA
tensors that need a gradient take the kernel or raise; there is no
fallback. :func:`nbr_gather_backward_plain` repeats the kernel's
arithmetic, order of additions included. ``nbr_gather_backward.launches``
counts the backwards.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels._launch import check_cuda_inputs, raise_on

CHUNK = 64                          # NBR_CHUNK in csrc/nbr_gather.cu

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_library("nbr_gather")
        lib.nbr_gather_backward_level.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.nbr_gather_backward_level.restype = ctypes.c_int
        lib.nbr_gather_error_string.argtypes = [ctypes.c_int]
        lib.nbr_gather_error_string.restype = ctypes.c_char_p
        lib.nbr_gather_chunk.argtypes = []
        lib.nbr_gather_chunk.restype = ctypes.c_int
        if lib.nbr_gather_chunk() != CHUNK:
            raise RuntimeError("csrc/nbr_gather.cu and nbr_gather.py disagree on CHUNK")
        _lib = lib
    return _lib


def gather_plan(nbr_idx: torch.Tensor, nodes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(perm, keys)``, both int32 over the flattened slots of ``nbr_idx``:
    the slot ids in a stable order by index, and the index of each. A
    negative index counts from the end of the ``nodes`` rows, as in the
    forward."""
    flat = nbr_idx.reshape(-1).to(torch.int32)
    flat = torch.where(flat < 0, flat + nodes, flat)
    keys, order = torch.sort(flat, stable=True)
    return order.to(torch.int32), keys


def _level_plain(vals, keys, dx) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """One level of the kernel over the rows ``vals`` (H, n, F) in the order
    of their ``keys`` (n,): every chunk of ``CHUNK`` rows adds each run of
    equal keys in order, writes the runs that lie inside it to ``dx`` and
    leaves its L and R partials (the run it began inside, if that started in
    an earlier chunk; the run that starts inside it and goes on past it).
    Returns the next level's rows and keys, or ``None`` after one chunk."""
    heads, n, f = vals.shape
    chunks = -(-n // CHUNK)
    pad = chunks * CHUNK - n
    kp = torch.cat([keys, keys.new_full((pad,), -1)]).view(chunks, CHUNK)
    vp = torch.cat([vals, vals.new_zeros(heads, pad, f)], 1).view(heads, chunks, CHUNK, f)
    starts = torch.arange(chunks, device=keys.device) * CHUNK
    ends = (starts + CHUNK).clamp(max=n)
    cur = kp[:, 0].clone()
    before = (starts > 0) & (keys[(starts - 1).clamp(min=0)] == cur)
    after = (ends < n) & (keys[ends.clamp(max=n - 1)] == keys[ends - 1])
    first = torch.ones_like(before)
    acc = vals.new_zeros(heads, chunks, f)
    l_val, r_val = torch.zeros_like(acc), torch.zeros_like(acc)
    l_key, r_key = torch.full_like(cur, -1), torch.full_like(cur, -1)

    def flush(mask, ends_after):
        nonlocal l_val, l_key, r_val, r_key
        live = mask & (cur >= 0)
        began = first & before
        to_l, to_r = live & began, live & ~began & ends_after
        direct = live & ~began & ~ends_after
        l_val, l_key = torch.where(to_l[None, :, None], acc, l_val), torch.where(to_l, cur, l_key)
        r_val, r_key = torch.where(to_r[None, :, None], acc, r_val), torch.where(to_r, cur, r_key)
        dx[:, cur[direct].long()] = acc[:, direct]

    for i in range(CHUNK):
        k = kp[:, i]
        change = k != cur
        flush(change, torch.zeros_like(change))
        first = first & ~change
        cur = torch.where(change, k, cur)
        acc = torch.where(change[None, :, None], 0.0, acc) + vp[:, :, i]
    flush(torch.ones_like(first), after)
    if chunks == 1:
        return None
    part = torch.stack([l_val, r_val], 2).reshape(heads, 2 * chunks, f)
    return part, torch.stack([l_key, torch.where(r_key >= 0, r_key, l_key)], 1).reshape(-1)


def nbr_gather_backward_plain(grad: torch.Tensor, nbr_idx: torch.Tensor,
                              nodes: int) -> torch.Tensor:
    """The plain version of the backward kernel, level by level, adding in
    the kernel's order: ``dx`` (H, nodes, F) of ``grad`` (H, *nbr_idx.shape,
    F)."""
    heads, f = grad.shape[0], grad.shape[-1]
    dx = grad.new_zeros(heads, nodes, f)
    if nbr_idx.numel() == 0:
        return dx
    perm, keys = gather_plan(nbr_idx, nodes)
    level = grad.reshape(heads, -1, f)[:, perm.long()], keys
    while level is not None:
        level = _level_plain(*level, dx)
    return dx


def _check_index(what, x, nbr_idx):
    if nbr_idx.device != x.device or nbr_idx.dtype != torch.int64:
        raise ValueError(f"{what}: nbr_idx must be int64 on {x.device}, got "
                         f"{nbr_idx.dtype} on {nbr_idx.device}")


def nbr_gather_backward(grad: torch.Tensor, nbr_idx: torch.Tensor, nodes: int) -> torch.Tensor:
    """``dx`` (H, nodes, F) of :func:`nbr_gather` given ``grad`` (H,
    *nbr_idx.shape, F) on a CUDA device: each node's slots summed by the
    kernel, one launch a level. Raises on what it cannot take, a CPU tensor
    included (:func:`nbr_gather_backward_plain` is the CPU's version)."""
    lib = _library()
    grad = grad.contiguous()
    heads, f = grad.shape[0], grad.shape[-1]
    if tuple(grad.shape) != (heads, *nbr_idx.shape, f):
        raise ValueError(f"nbr_gather backward: grad has shape {tuple(grad.shape)}, the "
                         f"forward's output (H, *{tuple(nbr_idx.shape)}, F)")
    src = grad.reshape(heads, -1, f)
    check_cuda_inputs("nbr_gather backward", {"grad": src}, (torch.float32,))
    _check_index("nbr_gather backward", src, nbr_idx)
    n = src.shape[1]
    if n >= 2 ** 31:
        raise ValueError(f"nbr_gather backward: {n} slots; the plan's int32 ids take < 2**31")
    dx = torch.zeros((heads, nodes, f), dtype=torch.float32, device=grad.device)
    if n == 0 or dx.numel() == 0:
        return dx
    perm, keys = gather_plan(nbr_idx, nodes)
    with torch.cuda.device(grad.device):
        stream = torch.cuda.current_stream(grad.device).cuda_stream
        while True:
            chunks = -(-n // CHUNK)
            part = part_keys = None
            if chunks > 1:
                part = torch.empty((heads, 2 * chunks, f), dtype=torch.float32, device=grad.device)
                part_keys = torch.empty(2 * chunks, dtype=torch.int32, device=grad.device)
            rc = lib.nbr_gather_backward_level(
                src.data_ptr(), None if perm is None else perm.data_ptr(), keys.data_ptr(), n,
                heads, f, nodes, dx.data_ptr(), None if part is None else part.data_ptr(),
                None if part_keys is None else part_keys.data_ptr(), chunks,
                int(f % 4 == 0 and src.data_ptr() % 16 == 0), stream,
            )
            raise_on(rc, lib.nbr_gather_error_string, "nbr_gather backward")
            if part is None:
                break
            src, perm, keys, n = part, None, part_keys, 2 * chunks
    nbr_gather_backward.launches += 1
    return dx


class NbrGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, nbr_idx):
        ctx.save_for_backward(nbr_idx)
        ctx.nodes = x.shape[1]
        return x[:, nbr_idx, :]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (nbr_idx,) = ctx.saved_tensors
        return nbr_gather_backward(grad, nbr_idx, ctx.nodes), None


def nbr_gather(x: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """``x[:, nbr_idx, :]``: x (H, N, F), nbr_idx (N', B) int64 -> (H, N',
    B, F). On the CPU, or where no gradient is needed, this is plain
    indexing. A CUDA ``x`` that needs a gradient must be float32 with
    ``nbr_idx`` int64 on its device; its backward is
    :func:`nbr_gather_backward`'s kernel."""
    if x.device.type == "cpu" or not (x.requires_grad and torch.is_grad_enabled()):
        return x[:, nbr_idx, :]
    if x.dim() != 3:
        raise ValueError(f"nbr_gather: x must be (H, N, F), got {tuple(x.shape)}")
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise TypeError(f"nbr_gather: x needs a gradient, so it must be float32 on a CUDA "
                        f"device, got {x.dtype} on {x.device}")
    _check_index("nbr_gather", x, nbr_idx)
    return NbrGather.apply(x, nbr_idx)


nbr_gather_backward.launches = 0
