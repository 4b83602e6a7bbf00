"""Plain float32 FedGAT of any depth with the GAT paper's skip, one round
of paper Algorithm 2 and the comparison: the yardstick of the cells whose
model has more than two layers (``traffic/federated_deep.py``).

The layers are :mod:`bench.reference.fedgat`'s (layer 1 by Eq. 7 straight
over the padded neighbour lists, the exact GAT layer of Eq. 1-3); what is
added is the depth and the skip of the inductive model (Veličković et al.
2018, §3.3; ``attn_head(..., residual=True)`` in the authors' code): each
hidden layer after the first adds ``x P_k`` for each head k, concatenated,
to its attention output before the ELU. The output layer averages its
heads. No bias, as in the program. The round is Algorithm 2 without
privacy: every chosen client's local Adam steps from the global params,
then their mean. The comparison is :mod:`bench.reference.judge`'s five
numbers, with the evaluation's logits taken from this forward.

Nothing of the program is imported; the caller sets the precision (TF32
off, or on for the control).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from bench.reference import frozen, judge as base_judge
from bench.reference.fedgat import (
    Problem,
    RoundReading,
    RoundSpec,
    adam_step,
    elu,
    gat_layer,
    layer1_direct,
    masked_ce,
)

def layer_keys(model: dict) -> List[tuple]:
    """The leaves' keys a layer, in the program's tree order: W, a1, a2,
    and P on each hidden layer after the first when the model has the
    skip."""
    depth, skip = int(model["num_layers"]), bool(model.get("skip", False))
    return [("W", "a1", "a2", "P") if skip and 0 < li < depth - 1 else ("W", "a1", "a2")
            for li in range(depth)]


def params_of(model: dict, leaves: Sequence[torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    it = iter(leaves)
    return [{k: next(it) for k in keys} for keys in layer_keys(model)]


def forward(pr: Problem, params, skip: bool = True) -> torch.Tensor:
    """Class logits (N, C); ``skip=False`` leaves P out (a planted fault)."""
    x = elu(layer1_direct(pr, params[0]))
    for p in params[1:-1]:
        out = gat_layer(pr, p, x, concat=True)
        if skip and "P" in p:
            out = out + torch.einsum("nd,hdo->nho", x, p["P"]).reshape(out.shape)
        x = elu(out)
    return gat_layer(pr, params[-1], x, concat=False)


def run_round(pr: Problem, p0: Sequence[torch.Tensor], spec: RoundSpec,
              fault: Optional[str] = None) -> RoundReading:
    """Round 0 of Algorithm 2 from the global leaves ``p0``, as
    :func:`bench.reference.fedgat.run_round` takes it for a traffic without
    privacy or cohorts. ``fault`` plants one of
    :mod:`bench.reference.fedgat`'s faults (``"half_batch"``,
    ``"exchange"``, ``"answer"``, ``"unchanged"``) or ``"skip_dropped"``
    (every forward without the skip)."""
    if spec.cohort is not None or spec.secure_agg or spec.noise_multiplier > 0 \
            or np.isfinite(spec.clip):
        raise NotImplementedError("the deep reference follows rounds without privacy or cohorts")
    model = pr.model
    owner = frozen.dirichlet_partition(pr.labels_np, spec.num_clients, spec.beta, spec.run_seed)
    _, chosen = frozen.selection_schedule(spec.run_seed, 1, spec.num_clients,
                                          spec.client_fraction)
    skip = fault != "skip_dropped"
    p0 = [t.detach().clone() for t in p0]
    losses, grad1, local = [], [], []
    for c in chosen[0].tolist():
        tr_np = frozen.client_train_mask(owner, pr.train_mask, c)
        if fault == "half_batch":
            tr_np = tr_np.copy()
            tr_np[np.nonzero(tr_np)[0][1::2]] = False
        tr = torch.as_tensor(tr_np, device=pr.features.device)
        leaves = list(p0)
        mu = [torch.zeros_like(t) for t in leaves]
        nu = [torch.zeros_like(t) for t in leaves]
        for s in range(spec.local_steps):
            req = [t.detach().requires_grad_(True) for t in leaves]
            with torch.enable_grad():
                loss = masked_ce(forward(pr, params_of(model, req), skip), pr.labels, tr)
                grads = torch.autograd.grad(loss, req, allow_unused=not skip)
            grads = [torch.zeros_like(t) if g is None else g for t, g in zip(req, grads)]
            losses.append(float(loss.detach()))
            if s == 0:
                grad1.append([g.detach().clone() for g in grads])
            del loss, req
            new, mu, nu = adam_step(leaves, grads, mu, nu, s + 1, spec.lr, spec.weight_decay)
            leaves = leaves if fault == "unchanged" else new
        local.append([t.clone() for t in leaves])
    shipped = local[:1] if fault == "exchange" else local
    new_global = [torch.stack(ts).mean(0) for ts in zip(*shipped)]
    with torch.no_grad():
        logits = forward(pr, params_of(model, new_global), skip)
    if fault == "answer":
        logits[0, 0] += 1.0
    return RoundReading(losses, grad1, local, new_global, logits)


@torch.no_grad()
def eval_logits(pr: Problem, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    return forward(pr, params_of(pr.model, list(leaves)))


def _eval_gap(pr: Problem, params: Sequence[torch.Tensor], logits: torch.Tensor) -> float:
    judged = eval_logits(pr, params)
    return float((logits.to(judged.device) - judged).abs().max()
                 / judged.abs().max().clamp_min(1e-30))


def judge(pr: Problem, p0: Sequence[torch.Tensor], prog: RoundReading, ref: RoundReading,
          window_params: Sequence[Sequence[torch.Tensor]] = (),
          window_logits: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """:func:`bench.reference.judge.judge`'s numbers, the evaluation's
    logits held against this module's forward."""
    if len(prog.losses) != len(ref.losses) or len(prog.grad1) != len(ref.grad1):
        raise ValueError(
            f"the program ran {len(prog.losses)} local steps over {len(prog.grad1)} "
            f"clients, the reference {len(ref.losses)} over {len(ref.grad1)}")
    norms, worst = base_judge._norms, base_judge._worst_leaf
    kept = base_judge.kept_leaves(ref)
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog.losses, ref.losses))
    grad1 = max(worst(norms(gp), norms(gr), kept) for gp, gr in zip(prog.grad1, ref.grad1))

    def change(leaves):
        return norms([t - t0 for t, t0 in zip(leaves, p0)])

    local = max(worst(change(lp), change(lr), kept) for lp, lr in zip(prog.local, ref.local))
    rounds = [worst(change(g), change(ref.global_params), kept)
              for g in [prog.global_params, *window_params]]
    evals = [_eval_gap(pr, prog.global_params, prog.eval_logits)]
    if window_logits is not None:
        evals.append(_eval_gap(pr, window_params[-1], window_logits))
    out = {"loss": loss, "grad1": grad1, "local": local, "round": max(rounds),
           "eval": max(evals)}
    if window_params:
        out.update(round_window=max(rounds[1:]), eval_window=max(evals[1:], default=None))
    return out
