"""Least work of the ``cheb_attn`` kernels at a launch's shape.

A frozen copy of ``chip_smoke.py:356-383`` (``cheb_attn_bound_ms`` and
``cheb_attn_bwd_bound_ms``), taking the shapes instead of the tensors:
each input byte is read once and each output byte written once, whatever
the kernel reads again, and the float32 operations are Horner's for the
series (and its derivative in the backward), the mask, the denominator,
the numerator and the division.

Shapes: ``heads`` H, ``nodes`` N, neighbour slots B, feature width D and
``coeffs`` P (the series' degree plus one), all float32.
"""
from __future__ import annotations

from typing import Sequence, Tuple

from bench.counts.peaks import FP32_FLOPS_PER_S, HBM_BYTES_PER_S


def forward(heads: int, nodes: int, b: int, d: int, coeffs: int) -> Tuple[int, int]:
    """(flops, bytes) of one forward launch: x (H, N, B), h_nb (N, B, D),
    mask (N, B) and the coefficients read, out (H, N, D) written."""
    x, out = heads * nodes * b, heads * nodes * d
    nbytes = 4 * (x + nodes * b * d + nodes * b + coeffs + out)
    flops = x * (2 * coeffs + 1 + 1 + 2 * d) + out
    return flops, nbytes


def backward(heads: int, nodes: int, b: int, d: int, coeffs: int,
             needs: Sequence[bool] = (True, False, False, False)) -> Tuple[int, int]:
    """(flops, bytes) of one backward launch computing the cotangents in
    ``needs`` (x, h_nb, mask, coeffs): the forward's inputs and dout read,
    each asked-for cotangent written. Layer 1 asks for dx alone."""
    x, h_nb, mask, out = heads * nodes * b, nodes * b * d, nodes * b, heads * nodes * d
    written = sum(n for n, need in zip((x, h_nb, mask, coeffs), needs) if need)
    nbytes = 4 * (x + h_nb + mask + coeffs + out + written)
    per_score = 4 * coeffs + 5 * d + 3
    per_score += 2 * d * needs[1] + 2 * needs[2] + 2 * coeffs * needs[3]
    return x * per_score, nbytes


def least_seconds(flops: int, nbytes: int) -> float:
    """The larger of the operations at the float32 peak and the bytes at
    the HBM peak."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
