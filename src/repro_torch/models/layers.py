"""Shared transformer building blocks over parameter trees (the port of
``repro/models/layers.py``).

Parameters are nested dicts of tensors with the reference's keys. Each
``init_*`` returns a tree of :class:`Draw`/:class:`Fill` leaf specs rather
than tensors; :func:`materialize` turns a spec tree into tensors, one
leading slice at a time, so a stacked (L, ...) weight is never drawn whole
in float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._tree import tree_map


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


def init_dense(d_in: int, d_out: int, bias: bool = False) -> Dict:
    p = {"w": Draw((d_in, d_out), d_in ** -0.5)}
    if bias:
        p["b"] = Fill((d_out,), 0.0)
    return p


def init_rmsnorm(d: int) -> Dict:
    return {"scale": Fill((d,), 1.0)}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def init_embedding(vocab: int, d: int) -> Dict:
    return {"table": Draw((vocab, d), 0.02)}


def embed(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["table"])


def unembed(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["table"].T


def swiglu_init(d: int, d_ff: int) -> Dict:
    return {
        "w_gate": init_dense(d, d_ff),
        "w_up": init_dense(d, d_ff),
        "w_down": init_dense(d_ff, d),
    }


def swiglu(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return dense(p["w_down"], F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x))


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
