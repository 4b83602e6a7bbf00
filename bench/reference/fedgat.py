"""Plain float32 FedGAT and one round of paper Algorithm 2, the yardstick.

Written from the paper's equations in plain torch: no kernel, no pack,
no batching over clients, and nothing of the program imported. Layer 1 is
FedGAT's polynomial attention (Eq. 7) directly over the padded neighbour
lists, which is what both engines compute: the ``kernel`` engine in its
CUDA kernels, the ``vector`` engine through the Appendix F pack, whose
masked slots are multiplied by zero. Layer 2 is the exact GAT layer
(Eq. 1-3). Training is
masked cross-entropy under Adam with weight decay, clients' deltas go
through DP-FedAvg and pairwise masks where the traffic asks for them,
and FedAvg takes their mean. Gathers use ``index_select``, whose backward
is an ``index_add_``.

The caller sets the precision: the reference runs with TF32 off, and the
control of the benchmark runs the same code with it on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench.reference import frozen

Params = List[Dict[str, torch.Tensor]]
LEAF_KEYS = ("W", "a1", "a2")


def params_of(leaves: Sequence[torch.Tensor]) -> Params:
    """Leaves in the program's tree order (layer by layer: W, a1, a2) as
    layers of parameters."""
    it = iter(leaves)
    return [{k: next(it) for k in LEAF_KEYS} for _ in range(len(leaves) // len(LEAF_KEYS))]


@dataclass
class Problem:
    """The inputs both sides are handed, on the reference's device."""

    features: torch.Tensor        # (N, d) float32
    labels: torch.Tensor          # (N,) int64
    nbr_idx: torch.Tensor         # (N, B) int64, capped lists as the frozen rule derives
    nbr_mask: torch.Tensor        # (N, B) bool
    train_mask: np.ndarray        # (N,) bool (host: partition and client masks)
    labels_np: np.ndarray         # (N,) int32
    model: dict                   # the configuration's model section
    coeffs: torch.Tensor = field(init=False)

    def __post_init__(self):
        m = self.model
        q = frozen.attention_power_series(m["degree"], tuple(m["domain"]), m["leaky_slope"])
        self.coeffs = torch.as_tensor(q, dtype=torch.float32, device=self.features.device)
        n, b = self.nbr_mask.shape
        self.nbr_flat = self.nbr_idx.reshape(-1)
        self.mask_f = self.nbr_mask.to(torch.float32)
        self.n, self.b = n, b


def horner(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros_like(x)
    for qn in q.flip(0):
        acc = acc * x + qn
    return acc


def projections(p) -> tuple:
    """b1 = W^T a1, b2 = W^T a2 per head (Eq. 4): (H, d_in) each."""
    b1 = torch.einsum("hdo,ho->hd", p["W"], p["a1"])
    b2 = torch.einsum("hdo,ho->hd", p["W"], p["a2"])
    return b1, b2


def heads_out(agg: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(N, H, d) aggregates projected by each head's W and concatenated."""
    out = torch.einsum("nhd,hdo->nho", agg, W)
    return out.reshape(out.shape[0], -1)


def layer1_direct(pr: Problem, p) -> torch.Tensor:
    """e_ij = q(b1.h_i + b2.h_j) on the neighbour slots; out_i = W^T sum_j
    e_ij h_j / sum_j e_ij, zero where the denominator is zero."""
    h = pr.features
    b1, b2 = projections(p)
    s1 = h @ b1.T                                             # (N, H)
    s2 = h @ b2.T
    x = s1[:, :, None] + s2.index_select(0, pr.nbr_flat).view(pr.n, pr.b, -1).transpose(1, 2)
    e = horner(pr.coeffs, x) * pr.mask_f[:, None, :]          # (N, H, B)
    h_nb = h.index_select(0, pr.nbr_flat).view(pr.n, pr.b, -1) * pr.mask_f[..., None]
    num = torch.bmm(e, h_nb)                                  # (N, H, d)
    den = e.sum(-1, keepdim=True)
    ok = den != 0
    agg = torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(num))
    return heads_out(agg, p["W"])


def gat_layer(pr: Problem, p, x: torch.Tensor, concat: bool) -> torch.Tensor:
    """Exact GAT over the padded neighbour lists (Eq. 1-3)."""
    z = torch.einsum("nd,hdo->hno", x, p["W"])                # (H, N, o)
    s1 = (z * p["a1"][:, None, :]).sum(-1)                    # (H, N)
    s2 = (z * p["a2"][:, None, :]).sum(-1)
    heads = z.shape[0]
    logits = s1[:, :, None] + s2.index_select(1, pr.nbr_flat).view(heads, pr.n, pr.b)
    logits = torch.where(logits >= 0, logits, 0.2 * logits)
    mask = pr.nbr_mask[None]
    logits = torch.where(mask, logits, torch.full_like(logits, -torch.inf))
    alpha = torch.softmax(logits, dim=-1)
    alpha = torch.where(mask, alpha, torch.zeros_like(alpha))
    zn = z.index_select(1, pr.nbr_flat).view(heads, pr.n, pr.b, -1)
    out = torch.einsum("hnb,hnbo->hno", alpha, zn)
    if concat:
        return out.permute(1, 0, 2).reshape(pr.n, -1)
    return out.mean(dim=0)


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(x))


def forward(pr: Problem, params: Params) -> torch.Tensor:
    """Class logits (N, C): layer 1, ELU, exact GAT layers after."""
    x = elu(layer1_direct(pr, params[0]))
    for li in range(1, len(params)):
        last = li == len(params) - 1
        x = gat_layer(pr, params[li], x, concat=not last)
        if not last:
            x = elu(x)
    return x


def masked_ce(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


@torch.no_grad()
def adam_step(leaves, grads, mu, nu, step: int, lr: float, wd: float,
              b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """Adam with decoupled weight decay, everything in float32, the bias
    corrections too (1 - 0.999 differs from its float64 value by 1.3e-5)."""
    t = torch.tensor(float(step), dtype=torch.float32, device=leaves[0].device)
    mu = [b1 * m + (1 - b1) * g for m, g in zip(mu, grads)]
    nu = [b2 * v + (1 - b2) * g * g for v, g in zip(nu, grads)]
    bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
    new = [p - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * p)
           for p, m, v in zip(leaves, mu, nu)]
    return new, mu, nu


@dataclass
class RoundReading:
    """What one round of the program or of the reference produced, in the
    terms the benchmark compares: each local step's loss, each client's
    first gradient and local params, the round's global params, and the
    evaluation's logits."""

    losses: List[float]
    grad1: List[List[torch.Tensor]]     # per client, per leaf
    local: List[List[torch.Tensor]]     # per client, per leaf, after its local steps
    global_params: List[torch.Tensor]   # per leaf, after the round
    eval_logits: Optional[torch.Tensor] = None


@dataclass
class RoundSpec:
    """One round's traffic, as the reference reads it."""

    run_seed: int
    num_clients: int
    beta: float
    client_fraction: float
    local_steps: int
    lr: float
    weight_decay: float
    cohort: Optional[int] = None          # lanes of a cohort; None: one lane a client
    noise_multiplier: float = 0.0
    clip: float = float("inf")
    secure_agg: bool = False
    mask_scale: float = 1.0


def run_round(pr: Problem, p0: Sequence[torch.Tensor], spec: RoundSpec,
              fault: Optional[str] = None) -> RoundReading:
    """Round 0 of Algorithm 2 from the global leaves ``p0``: every chosen
    client runs its local Adam steps from fresh optimizer state on its own
    training labels, its update is privatised as the traffic asks, and the
    mean over clients is the new global model, evaluated on the full graph.

    ``fault`` plants one of the faults the benchmark's check must catch:
    ``"half_batch"`` (each client's loss over half its labels),
    ``"exchange"`` (the mean left to the first client alone),
    ``"answer"`` (one evaluation logit altered) or ``"unchanged"`` (local
    steps that return the global model).
    """
    owner = frozen.dirichlet_partition(pr.labels_np, spec.num_clients, spec.beta, spec.run_seed)
    sel, chosen = frozen.selection_schedule(spec.run_seed, 1, spec.num_clients,
                                            spec.client_fraction)
    n_sel = chosen.shape[1]
    std = frozen.dp_noise_std(spec.noise_multiplier, spec.clip, n_sel)
    dp = spec.noise_multiplier > 0 or np.isfinite(spec.clip)
    noise_base = frozen.noise_base_key(spec.run_seed)
    mask_base = frozen.mask_base_key(spec.run_seed)
    dev = pr.features.device
    p0 = [t.detach().clone() for t in p0]
    losses, grad1, local, shipped = [], [], [], []
    for c in chosen[0].tolist():
        tr_np = frozen.client_train_mask(owner, pr.train_mask, c)
        if fault == "half_batch":
            idx = np.nonzero(tr_np)[0]
            tr_np = tr_np.copy()
            tr_np[idx[1::2]] = False
        tr = torch.as_tensor(tr_np, device=dev)
        leaves = list(p0)
        mu = [torch.zeros_like(t) for t in leaves]
        nu = [torch.zeros_like(t) for t in leaves]
        for s in range(spec.local_steps):
            req = [t.detach().requires_grad_(True) for t in leaves]
            with torch.enable_grad():
                loss = masked_ce(forward(pr, params_of(req)), pr.labels, tr)
                grads = torch.autograd.grad(loss, req)
            losses.append(float(loss.detach()))
            if s == 0:
                grad1.append([g.detach().clone() for g in grads])
            new, mu, nu = adam_step(leaves, grads, mu, nu, s + 1, spec.lr, spec.weight_decay)
            leaves = leaves if fault == "unchanged" else new
        local.append([t.clone() for t in leaves])
        if dp:
            leaves = frozen.dp_transform(frozen.client_round_key(noise_base, 0, c), p0, leaves,
                                         spec.clip, std)
        if spec.secure_agg:
            mask = frozen.client_mask(mask_base, 0, c, sel[0], leaves, spec.mask_scale)
            leaves = [t + m for t, m in zip(leaves, mask)]
        shipped.append(leaves)
    if fault == "exchange":
        shipped = shipped[:1]
    if spec.cohort is None:
        new_global = [torch.stack(ts).mean(0) for ts in zip(*shipped)]
    else:
        acc = [torch.zeros_like(t) for t in p0]
        weight = 0.0
        for i in range(0, len(shipped), spec.cohort):
            chunk = shipped[i:i + spec.cohort]
            acc = [a + torch.stack(ts).sum(0) for a, ts in zip(acc, zip(*chunk))]
            weight += len(chunk)
        new_global = [a / weight for a in acc]
    with torch.no_grad():
        logits = forward(pr, params_of(new_global))
    if fault == "answer":
        logits = logits.clone()
        logits[0, 0] += 1.0
    return RoundReading(losses, grad1, local, new_global, logits)


@torch.no_grad()
def eval_logits(pr: Problem, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return forward(pr, params_of(list(leaves)))
