"""The kernels exposed to the rest of the port: FedGAT layer 1 through the
fused ``cheb_attn`` kernel (the ``kernel`` engine), flat and degree-bucketed,
and the sequence kernels.

The port of ``repro/kernels/ops.py``. The reference pads N and d to block
multiples chosen by a TPU VMEM cost model (``select_block_sizes``, with its
memo ``clear_block_cache``) and picks interpret mode per backend
(``resolve_interpret``); the CUDA kernels mask ragged edges themselves and
always run compiled, so none of the three is carried over.
"""
from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.cheb_attn import cheb_attn
from repro_torch.kernels.flash_attn import flash_attn
from repro_torch.kernels.poly_attn import poly_attn


def cheb_attn_layer(
    params: Mapping[str, torch.Tensor],
    coeffs: torch.Tensor,
    h: torch.Tensor,
    nbr_idx: torch.Tensor,
    nbr_mask: torch.Tensor,
    *,
    basis: str = "power",
    domain: Tuple[float, float] = (-4.0, 4.0),
    concat: bool = True,
) -> torch.Tensor:
    """FedGAT layer 1 via the fused kernel: all heads aggregate in one
    launch, then the output projection W — numerically the direct engine.
    Isolated nodes come out as exact zeros before the projection.
    Differentiable: the scores carry the parameters' gradient into
    ``cheb_attn``'s backward kernel (and ``h`` its own, when it needs one).
    ``domain`` is unused by the monomial basis and kept for the engine
    interface."""
    if basis != "power":
        raise ValueError("kernel engine evaluates the monomial (power) basis")
    # Imported here: repro_torch.core imports this module for its engines.
    from repro_torch.core.poly_attention import edge_scores, head_projections

    n = h.shape[0]
    b1, b2 = head_projections(params)
    x = edge_scores(b1, b2, h, nbr_idx)                  # (H, N, B)
    mask_f = nbr_mask.to(h.dtype)                        # (N, B)
    h_nb = h[nbr_idx] * mask_f[..., None]                # (N, B, d)
    agg = cheb_attn(x, h_nb, mask_f, coeffs)             # (H, N, d)
    out = torch.einsum("hnd,hdo->hno", agg, params["W"])  # (H, N, d_out)
    if concat:
        return out.permute(1, 0, 2).reshape(n, -1)
    return out.mean(dim=0)


def degree_bucket_plan(
    nbr_mask: np.ndarray, *, pad_multiple: int = 8, max_buckets: int = 4
) -> List[Tuple[np.ndarray, int]]:
    """Partition rows into degree buckets for :func:`cheb_attn_layer_bucketed`.

    One flat (N, B) launch pays O(N * B) padded work even when B is set by a
    handful of hubs. This groups rows by degree into at most ``max_buckets``
    buckets with power-of-two neighbour capacities (``pad_multiple`` * 2^k,
    topped by B), so each row's padded slots are within 2x of its degree
    instead of within B. Returns ``[(row_indices, b_cap), ...]`` covering
    every row exactly once (empty buckets dropped). Host-side numpy, as the
    reference's.
    """
    mask = np.asarray(nbr_mask)
    deg = mask.sum(axis=1).astype(np.int64)
    B = mask.shape[1]
    caps = []
    c = max(pad_multiple, 1)
    while c < B:
        caps.append(c)
        c *= 2
    caps.append(B)
    if len(caps) > max_buckets:
        caps = caps[-max_buckets:]      # merge the smallest-degree buckets
    plan = []
    prev = -1                            # first bucket swallows deg-0 rows
    for cap in caps:
        rows = np.nonzero((deg > prev) & (deg <= cap))[0]
        if len(rows):
            plan.append((rows, int(cap)))
        prev = cap
    return plan


def cheb_attn_layer_bucketed(
    params: Mapping[str, torch.Tensor],
    coeffs: torch.Tensor,
    h: torch.Tensor,
    nbr_idx,
    nbr_mask,
    *,
    plan: Optional[List[Tuple[np.ndarray, int]]] = None,
    basis: str = "power",
    concat: bool = True,
) -> torch.Tensor:
    """:func:`cheb_attn_layer` with one ``cheb_attn`` launch per degree
    bucket, each with its neighbour axis trimmed to the bucket's capacity.
    Padded slots contribute exact zeros in either form, so the output is the
    flat layer's; the padded work drops from O(N * B_max) to ~O(sum_i 2 deg_i).
    Differentiable through the kernel's backward, as the flat layer.

    ``nbr_idx``/``nbr_mask`` are numpy arrays or tensors; tensors already on
    ``h``'s device (as the flat layer takes them), and a ``plan`` whose row
    indices are such tensors, are used as they are, so nothing is uploaded
    per call. Without ``plan`` it is made from a host copy of ``nbr_mask``.
    Trimming relies on the valid slots forming a prefix of each padded row,
    which ``csr_to_padded`` guarantees.
    """
    if basis != "power":
        raise ValueError("kernel engine evaluates the monomial (power) basis")
    from repro_torch.core.poly_attention import head_projections

    if plan is None:
        host_mask = nbr_mask.cpu().numpy() if torch.is_tensor(nbr_mask) else nbr_mask
        plan = degree_bucket_plan(host_mask)
    n, d = h.shape
    b1, b2 = head_projections(params)
    s1 = torch.einsum("nd,hd->hn", h, b1)                 # (H, N)
    s2 = torch.einsum("nd,hd->hn", h, b2)
    heads = s1.shape[0]
    co = torch.as_tensor(coeffs, dtype=torch.float32, device=h.device)

    idx_all = torch.as_tensor(nbr_idx, device=h.device)  # buckets are cut on the device
    mask_all = torch.as_tensor(nbr_mask, device=h.device)
    agg = torch.zeros((heads, n, d), dtype=h.dtype, device=h.device)
    for rows, cap in plan:
        rows_t = torch.as_tensor(rows, dtype=torch.int64, device=h.device)
        nb = idx_all[rows_t, :cap].long()                 # (n_k, cap)
        mask_f = mask_all[rows_t, :cap].to(h.dtype)
        x = s1[:, rows_t, None] + s2[:, nb]               # (H, n_k, cap)
        h_nb = h[nb] * mask_f[..., None]                  # (n_k, cap, d)
        agg.index_copy_(1, rows_t, cheb_attn(x, h_nb, mask_f, co))

    out = torch.einsum("hnd,hdo->hno", agg, params["W"])
    if concat:
        return out.permute(1, 0, 2).reshape(n, -1)
    return out.mean(dim=0)


__all__ = [
    "cheb_attn",
    "flash_attn",
    "poly_attn",
    "cheb_attn_layer",
    "cheb_attn_layer_bucketed",
    "degree_bucket_plan",
    "ref",
]
