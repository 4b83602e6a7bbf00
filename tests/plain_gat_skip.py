"""Plain PyTorch float32 reference of the GAT paper's inductive model as the
port trains it federatedly: the yardstick of ``tests/test_torch_gat_skip.py``
and of the card test in ``tests/test_torch_cuda.py``.

Written from the equations, in plain ``torch`` operations over padded
neighbour lists: no kernel, no pack, no batching over clients. It imports
nothing of ``jax``, of ``repro`` or of ``repro_torch``; the caller turns
TF32 off on a card (:func:`float32_matmuls`).

The model (Veličković et al. 2018, arXiv:1710.10903 §3.3, the PPI model;
the skip as ``attn_head(..., residual=True)`` in github.com/PetarV-/GAT):

- layer 1 is FedGAT's (paper Eq. 7): per head k, b1 = W_k a1_k and
  b2 = W_k a2_k, e_ij = q(b1.h_i + b2.h_j) over i's neighbour slots with q
  the power series of exp(LeakyReLU) on the domain, and
  out_i = W_k^T (sum_j e_ij h_j / sum_j e_ij), zero where the denominator
  is zero; or, with ``layer1="exact"``, an exact GAT layer (the ``exact``
  engine); heads concatenated, then ELU;
- each hidden layer after the first: z_k = x W_k, alpha_ij = softmax_j
  LeakyReLU(z_i a1_k + z_j a2_k) over i's neighbour slots, and
  h_i = ELU( ||_k [ sum_j alpha_ij z_j,k + x_i P_k ] ): the skip is a
  learned projection of the layer's input, since its width (heads x
  hidden) differs from a head's;
- the output layer: the same attention, its heads averaged, no skip;
- the loss: the mean cross-entropy over the masked nodes.

Departures from the paper, as in every configuration of the port: no bias
in any layer (the port's layers hold W, a1 and a2 only, so P has none);
a softmax cross-entropy over single labels in place of PPI's 121 sigmoid
labels; no dropout.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

Params = List[Dict[str, torch.Tensor]]


def attention_series(degree: int, domain=(-4.0, 4.0), slope: float = 0.2) -> np.ndarray:
    """Monomial coefficients q_0..q_p of the degree-p Chebyshev interpolant
    of exp(LeakyReLU(x)) at the Chebyshev nodes of a symmetric ``domain``."""
    lo, hi = domain
    n = degree + 1
    k = np.arange(n)
    t = np.cos((2 * k + 1) * np.pi / (2 * n))
    y = np.exp(np.where(t * hi >= 0, t * hi, slope * t * hi))
    c = np.polynomial.chebyshev.chebfit(t, y, degree)          # in x / hi
    return np.polynomial.chebyshev.cheb2poly(c) * float(hi) ** -np.arange(n)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(x))


def neighbours(x: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (N, ...) at every slot: (N, B, ...)."""
    return x.index_select(0, nbr_idx.reshape(-1)).unflatten(0, nbr_idx.shape)


def poly_layer(p, h, nbr_idx, nbr_mask, q) -> torch.Tensor:
    """FedGAT layer 1 (Eq. 7), heads concatenated: (N, H * d_out)."""
    b1 = torch.einsum("hdo,ho->hd", p["W"], p["a1"])
    b2 = torch.einsum("hdo,ho->hd", p["W"], p["a2"])
    s1, s2 = h @ b1.T, h @ b2.T                                    # (N, H)
    x = s1[:, None, :] + neighbours(s2, nbr_idx)                   # (N, B, H)
    e = torch.zeros_like(x)
    for qn in q.flip(0):                                           # Horner
        e = e * x + qn
    e = e * nbr_mask[..., None].to(x.dtype)
    num = torch.einsum("nbh,nbd->nhd", e, neighbours(h, nbr_idx))  # (N, H, d)
    den = e.sum(1)[..., None]
    agg = torch.where(den != 0, num / torch.where(den != 0, den, 1.0), 0.0)
    return torch.einsum("nhd,hdo->nho", agg, p["W"]).flatten(1)


def attention(p, x, nbr_idx, nbr_mask) -> torch.Tensor:
    """Exact GAT attention per head (Eq. 1-3): (N, H, d_out)."""
    z = torch.einsum("nd,hdo->nho", x, p["W"])
    s1 = torch.einsum("nho,ho->nh", z, p["a1"])
    s2 = torch.einsum("nho,ho->nh", z, p["a2"])
    logits = leaky_relu(s1[:, None, :] + neighbours(s2, nbr_idx))   # (N, B, H)
    mask = nbr_mask[..., None]
    alpha = torch.softmax(torch.where(mask, logits, -torch.inf), dim=1)
    alpha = torch.where(mask, alpha, 0.0)                           # isolated rows
    return torch.einsum("nbh,nbho->nho", alpha, neighbours(z, nbr_idx))


def forward(params: Params, h, nbr_idx, nbr_mask, q, *, layer1: str = "poly",
            skip: bool = True) -> torch.Tensor:
    """Class logits (N, C). ``layer1`` is ``"poly"`` (Eq. 7) or
    ``"exact"``; ``skip=False`` leaves the hidden layers' P out (a fault)."""
    if layer1 == "poly":
        x = poly_layer(params[0], h, nbr_idx, nbr_mask, q)
    else:
        x = attention(params[0], h, nbr_idx, nbr_mask).flatten(1)
    x = elu(x)
    for p in params[1:-1]:
        out = attention(p, x, nbr_idx, nbr_mask)
        if "P" in p and skip:
            out = out + torch.einsum("nd,hdo->nho", x, p["P"])
        x = elu(out.flatten(1))
    return attention(params[-1], x, nbr_idx, nbr_mask).mean(1)


def masked_cross_entropy(logits, labels, mask) -> torch.Tensor:
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def loss_and_grads(params: Params, h, nbr_idx, nbr_mask, q, labels, mask, **kw):
    """The masked cross-entropy and its gradient by leaf, in the params'
    order (layer by layer: W, a1, a2, then P where a layer has one)."""
    leaves = [t.detach().requires_grad_(True) for layer in params for t in layer.values()]
    it = iter(leaves)
    tree = [{k: next(it) for k in layer} for layer in params]
    with torch.enable_grad():
        loss = masked_cross_entropy(forward(tree, h, nbr_idx, nbr_mask, q, **kw), labels, mask)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


@torch.no_grad()
def adam_steps(params: Params, grad_fn, steps: int, lr: float, wd: float,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Params:
    """``steps`` Adam steps with decoupled weight decay from fresh moments:
    p - lr (m_hat / (sqrt(v_hat) + eps) + wd p), the bias corrections in
    float32."""
    keys = [list(layer) for layer in params]
    leaves = [t.detach().clone() for layer in params for t in layer.values()]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    for s in range(1, steps + 1):
        it = iter(leaves)
        grads = grad_fn([{k: next(it) for k in ks} for ks in keys])
        t = torch.tensor(float(s), dtype=torch.float32)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        mu = [b1 * m + (1 - b1) * g for m, g in zip(mu, grads)]
        nu = [b2 * v + (1 - b2) * g * g for v, g in zip(nu, grads)]
        leaves = [p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p)
                  for p, m, v in zip(leaves, mu, nu)]
    it = iter(leaves)
    return [{k: next(it) for k in ks} for ks in keys]


def fedavg_round(params: Params, client_masks: Sequence[torch.Tensor], h, nbr_idx,
                 nbr_mask, q, labels, *, local_steps: int, lr: float, wd: float,
                 **kw) -> Params:
    """One round of Algorithm 2 with every client taking part: each runs its
    local Adam steps from the global params on its own training labels, and
    the new global params are the clients' mean."""
    clients = []
    for mask in client_masks:
        def grad_fn(p, mask=mask):
            return loss_and_grads(p, h, nbr_idx, nbr_mask, q, labels, mask, **kw)[1]
        clients.append(adam_steps(params, grad_fn, local_steps, lr, wd))
    return [{k: torch.stack([c[li][k] for c in clients]).mean(0) for k in layer}
            for li, layer in enumerate(params)]


class float32_matmuls:
    """TF32 off for the block (a card would otherwise round float32 GEMMs
    to TF32); ``tf32=True`` turns it on, for a control that must fail."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False
