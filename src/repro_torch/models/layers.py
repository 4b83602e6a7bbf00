"""Shared transformer building blocks over parameter trees (the port of
``repro/models/layers.py``).

Parameters are nested dicts of tensors with the reference's keys. Each
``init_*`` returns a tree of :class:`Draw`/:class:`Fill` leaf specs rather
than tensors; :func:`materialize` turns a spec tree into tensors, one
leading slice at a time, so a stacked (L, ...) weight is never drawn whole
in float32.

Tensor parallelism. While a megatron or zero1 step runs
(``launch/steps.py``), a rank holds of each param leaf the block that
``launch/sharding.py`` gives it on the mesh's ``model`` axis, as GSPMD does
for the reference, and the layers compute with those blocks (Megatron's
layout): a :class:`Region` is the part of a layer's inner width (heads,
FFN columns, channels) that this rank computes, between a column-split
product and the row-split product that ends it. Activations stay
replicated over ``model`` between regions. A replicated value enters a
region through ``pbroadcast`` (identity forward, its cotangents summed
over ``model`` backward) and the region's partial output leaves through
``psum`` (a sum forward, identity backward), so every replicated value's
cotangent is the true one on every rank. A whole leaf (replicated, or
gathered under the step's rule) of which a region uses a part enters
likewise. Off a mesh, and where a leaf's width does not split over the
axis, a region is the whole width and every function computes what it
computes on one device.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._tree import tree_map
from repro_torch.launch import pspec


@dataclass(frozen=True)
class Draw:
    """A float32 standard-normal draw times ``scale``, cast to the dtype."""
    shape: Tuple[int, ...]
    scale: float


@dataclass(frozen=True)
class Fill:
    """A constant: ``value`` (a float or an array broadcast to ``shape``)."""
    shape: Tuple[int, ...]
    value: Any


def materialize(spec: Any, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device, lead: Tuple[int, ...] = ()) -> Any:
    """Tensors on ``device`` for a spec tree, each with the leading axes
    ``lead`` (the reference's ``vmap``-stacked layer or expert axes). Draws
    come from ``generator`` on its own device, one leading slice at a time;
    on the ``meta`` device nothing is drawn or allocated."""
    n = int(np.prod(lead)) if lead else 1

    def make(leaf):
        out = torch.empty(lead + tuple(leaf.shape), dtype=dtype, device=device)
        if out.is_meta:             # shapes and dtypes only (launch/specs.py)
            return out
        flat = out.view((n,) + tuple(leaf.shape))
        if isinstance(leaf, Fill):
            value = torch.as_tensor(np.asarray(leaf.value, np.float32), device=device)
            flat.copy_(value.expand(flat.shape))
            return out
        for i in range(n):
            w = torch.randn(leaf.shape, generator=generator, device=generator.device,
                            dtype=torch.float32)
            flat[i].copy_(w * leaf.scale)
        return out

    return tree_map(make, spec)


def dense(p: Dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Tensor parallelism over the mesh's "model" axis (see the module docstring)
# ---------------------------------------------------------------------------

MODEL = ("model",)


def tp_view():
    """The rank's view of the mesh while a megatron or zero1 step runs
    (``pspec.active_mesh``), if it has a model axis; None otherwise."""
    mesh = pspec.active_mesh()
    return mesh if mesh is not None and "model" in mesh.axis_names else None


def held(n: int, full: int) -> Tuple[int, int]:
    """[lo, hi) of a dim ``full`` wide that a value ``n`` wide there holds:
    the whole, or this rank's block of the model axis."""
    if n == full:
        return 0, full
    tp = tp_view()
    if tp is None or n * tp.shape["model"] != full:
        raise ValueError(f"a part {n} wide of a dim {full} wide is not a block of the "
                         "model axis of a running tensor-parallel step")
    i = tp.coords["model"]
    return i * n, (i + 1) * n


class Region:
    """The part [lo, hi) of an inner width ``full`` that this rank computes,
    ``n`` wide: the block of the row-split leaf that ends the region, or the
    whole (then ``tp`` is None and the region adds nothing)."""

    def __init__(self, n: int, full: int):
        self.lo, self.hi = held(n, full)
        self.full = full
        self.tp = tp_view() if n < full else None

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated ``x`` that this rank uses inside the region."""
        return x if self.tp is None else self.tp.pbroadcast(x, MODEL)

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """The region's partial ``y``, summed over the model axis."""
        return y if self.tp is None else self.tp.psum(y, MODEL)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, this rank's part of the width (last dim), whole, for a use
        inside the region."""
        return x if self.tp is None else self.tp.pgather(x, -1, MODEL)

    def whole(self, w: torch.Tensor, full: int = None, dim: int = -1) -> torch.Tensor:
        """A whole leaf (replicated, or gathered by the step) that the region
        uses a part of; ``full``, when given, is its width along ``dim``."""
        if full is not None and w.shape[dim] != full:
            raise ValueError(f"a leaf {w.shape[dim]} wide is not the whole {full}")
        return self.enter(w)

    def take(self, w: torch.Tensor, lo: int = None, hi: int = None, full: int = None,
             dim: int = -1) -> torch.Tensor:
        """[lo, hi) (default: the region's) of a value ``full`` wide along
        ``dim`` (default: the region's width), from the leaf ``w``: the whole
        leaf, which enters the region, or this rank's block, which holds it."""
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        full = self.full if full is None else full
        a, b = held(w.shape[dim], full)
        if b - a == full:
            w = self.whole(w)
        elif lo < a or hi > b:
            raise ValueError(f"[{lo}, {hi}) is not in this rank's block [{a}, {b})")
        return w.narrow(dim, lo - a, hi - lo)


def dense_col(p: Dict, x: torch.Tensor, region: Region, lo: int = None, hi: int = None,
              full: int = None) -> torch.Tensor:
    """``dense`` of the output columns [lo, hi) (default: the region's) of a
    column-split leaf; ``x`` has entered the region."""
    y = x @ region.take(p["w"], lo, hi, full)
    if "b" in p:
        y = y + region.take(p["b"], lo, hi, full)
    return y


def dense_row(p: Dict, x: torch.Tensor, region: Region) -> torch.Tensor:
    """``dense`` of a row-split leaf on the region's part of its input: the
    partial products summed over the model axis, then the bias, once."""
    y = region.leave(x @ p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def init_dense(d_in: int, d_out: int, bias: bool = False) -> Dict:
    p = {"w": Draw((d_in, d_out), d_in ** -0.5)}
    if bias:
        p["b"] = Fill((d_out,), 0.0)
    return p


def init_rmsnorm(d: int) -> Dict:
    return {"scale": Fill((d,), 1.0)}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-5, region: Region = None) -> torch.Tensor:
    """RMS norm over the last dim; over its whole width when ``x`` is
    ``region``'s part of it (the sum of squares summed over the model axis)."""
    xf = x.to(torch.float32)
    if region is None or region.tp is None:
        var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        scale = p["scale"]
    else:
        ss = torch.sum(torch.square(xf), dim=-1, keepdim=True)
        var = region.enter(region.leave(ss)) / region.full
        scale = region.take(p["scale"])
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def init_embedding(vocab: int, d: int) -> Dict:
    return {"table": Draw((vocab, d), 0.02)}


def embed(p: Dict, tokens: torch.Tensor, vocab: int = None) -> torch.Tensor:
    """The rows of ``tokens``; vocab-parallel when the table is this rank's
    block of its ``vocab`` rows: the rank looks up the tokens it holds, zeros
    the others, and the ranks' parts are summed."""
    table = p["table"]
    if vocab is None or table.shape[0] == vocab:
        return F.embedding(tokens.long(), table)
    r = Region(table.shape[0], vocab)
    local = tokens.long() - r.lo
    mine = (local >= 0) & (local < r.hi - r.lo)
    x = F.embedding(torch.where(mine, local, 0), table)
    return r.leave(torch.where(mine[..., None], x, 0))


def unembed(p: Dict, x: torch.Tensor, vocab: int = None) -> torch.Tensor:
    """Logits; this rank's block of the ``vocab`` columns when the table is
    its block of the rows."""
    table = p["table"]
    if vocab is None:
        return x @ table.T
    return Region(table.shape[0], vocab).enter(x) @ table.T


def swiglu_init(d: int, d_ff: int) -> Dict:
    return {
        "w_gate": init_dense(d, d_ff),
        "w_up": init_dense(d, d_ff),
        "w_down": init_dense(d_ff, d),
    }


def swiglu(p: Dict, x: torch.Tensor, d_ff: int = None) -> torch.Tensor:
    """The SwiGLU MLP; on this rank's block of the ``d_ff`` columns when the
    leaves are its blocks."""
    w_down = p["w_down"]["w"]
    r = Region(w_down.shape[-2], d_ff or w_down.shape[-2])
    h = r.enter(x)
    return dense_row(p["w_down"], F.silu(dense_col(p["w_gate"], h, r)) * dense_col(p["w_up"], h, r),
                     r)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10_000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, mode: str = "standard") -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    mode="standard": rotate the full head_dim.
    mode="2d": ChatGLM-style 2D RoPE — rotate only the first half of
    head_dim, pass the second half through (arXiv:2406.12793).
    """
    if mode == "none":
        return x
    hd = x.shape[-1]
    rot_dim = hd if mode == "standard" else hd // 2
    freqs = rope_freqs(rot_dim, device=x.device)                  # (rot_dim/2,)
    angles = positions[..., None].to(torch.float32) * freqs       # (..., S, rot/2)
    angles = angles[..., None, :]                                 # (..., S, 1, rot/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    xr = x[..., :rot_dim].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    if rot_dim == hd:
        return rotated
    return torch.cat([rotated, x[..., rot_dim:]], dim=-1)


# ---------------------------------------------------------------------------
# Loops over time
# ---------------------------------------------------------------------------

# The tracer of a running program trace (``analysis.program`` sets it around
# a traced step, through :func:`scan_tracer`); None runs each loop as written.
_SCAN: Dict[str, Any] = {"tracer": None}


@contextlib.contextmanager
def scan_tracer(tracer):
    """Within: :func:`time_scan` hands its loops to ``tracer.scan``."""
    saved, _SCAN["tracer"] = _SCAN["tracer"], tracer
    try:
        yield
    finally:
        _SCAN["tracer"] = saved


def time_scan(step, carry: torch.Tensor, xs: Tuple[torch.Tensor, ...],
              consts: Tuple[torch.Tensor, ...] = ()) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence ``carry, y_t = step(carry, *(x[:, t] for x in xs),
    *consts)`` over t in ``range(xs[0].shape[1])`` (the reference's
    ``lax.scan`` over time); returns the last carry and the y_t stacked on
    dim 1. ``step`` reads no tensor but its arguments. Under a program trace
    the tracer counts one step for all of them (``analysis.program``)."""
    if _SCAN["tracer"] is not None:
        return _SCAN["tracer"].scan(step, carry, xs, consts)
    ys = []
    for t in range(xs[0].shape[1]):
        carry, y = step(carry, *(x[:, t] for x in xs), *consts)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)
