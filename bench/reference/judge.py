"""The comparison that decides ``correct``: what the program produced in a
round against what the reference produced from the same inputs.

Numbers, each read against a limit of its own:

- ``loss``: the widest relative gap between a local step's loss in the
  program and in the reference, over every local step of the round;
- ``grad1``: each client's first gradient, as the program's optimizer got
  it, by the worst kept leaf (below): per leaf, the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm of that leaf and of the median leaf; the worst client;
- ``local``: the norm of each client's change after its local steps, as
  the program's optimizer left it, by the worst kept leaf; the worst
  client;
- ``round``: the norm of the global model's change over the round (DP,
  masks and FedAvg included), by the worst kept leaf, of the warm call
  and of the first round of every window call;
- ``eval``: the widest gap between the program's evaluation logits and
  the reference's forward at the program's own global params, over the
  largest reference logit, of the warm call and of the window's last
  call's first round.

Which leaves are kept is a rule on the reference's first gradient,
averaged over the round's clients, never a name: half the median leaf's
or more. Left out are leaves whose gradient the attention cancels almost
whole, as the softmax cancels the destination's score (layer 2's ``a1``)
and nearly so the neighbour's at initialisation (layer 2's ``a2``). Such
a gradient follows the last bits of the layer below and jumps where one
edge's score crosses LeakyReLU's kink, so two sound float32 answers part
on it by 1e-4 of the median leaf on some seeds; Adam then scales its step
to about ``lr`` whatever the gradient, and the change parts further. At
these widths the rule keeps both ``W`` and layer 1's ``a2`` on every
seed; a fault in a left-out leaf's path moves ``W``'s gradient too, which
carries the same factors.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence

import torch

from bench.reference.fedgat import Problem, RoundReading, eval_logits

KEPT_GRAD = 0.5             # of the median leaf's first gradient


def _norms(leaves: Sequence[torch.Tensor]) -> List[float]:
    return [float(torch.linalg.vector_norm(t.to(torch.float64))) for t in leaves]


def leaf_gaps(prog: List[float], ref: List[float]) -> List[float]:
    """Per leaf, the gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf."""
    med = statistics.median(ref)
    return [abs(p - r) / max(r, med, 1e-30) for p, r in zip(prog, ref)]


def _worst_leaf(prog: List[float], ref: List[float], kept: Sequence[int]) -> float:
    gaps = leaf_gaps(prog, ref)
    return max(gaps[i] for i in kept)


def kept_leaves(ref: RoundReading) -> List[int]:
    """Leaves whose reference first gradient, averaged over the round's
    clients, is at least ``KEPT_GRAD`` of the median leaf's."""
    per_client = [_norms(g) for g in ref.grad1]
    mean = [sum(col) / len(col) for col in zip(*per_client)]
    med = statistics.median(mean)
    return [i for i, m in enumerate(mean) if m >= KEPT_GRAD * med]


def _eval_gap(pr: Problem, params: Sequence[torch.Tensor], logits: torch.Tensor) -> float:
    judged = eval_logits(pr, params)
    return float((logits.to(judged.device) - judged).abs().max()
                 / judged.abs().max().clamp_min(1e-30))


def judge(pr: Problem, p0: Sequence[torch.Tensor], prog: RoundReading, ref: RoundReading,
          window_params: Sequence[Sequence[torch.Tensor]] = (),
          window_logits: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """The numbers compared, by name. ``window_params`` are the first-round
    global params of the window's calls, ``window_logits`` the last one's
    evaluation logits. The reference's forward at the program's global
    params runs here, so call with the reference's precision set."""
    if len(prog.losses) != len(ref.losses) or len(prog.grad1) != len(ref.grad1):
        raise ValueError(
            f"the program ran {len(prog.losses)} local steps over {len(prog.grad1)} "
            f"clients, the reference {len(ref.losses)} over {len(ref.grad1)}")
    kept = kept_leaves(ref)
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog.losses, ref.losses))
    grad1 = max(_worst_leaf(_norms(gp), _norms(gr), kept)
                for gp, gr in zip(prog.grad1, ref.grad1))

    def change(leaves):
        return _norms([t - t0 for t, t0 in zip(leaves, p0)])

    local = max(_worst_leaf(change(lp), change(lr), kept)
                for lp, lr in zip(prog.local, ref.local))
    rounds = [_worst_leaf(change(g), change(ref.global_params), kept)
              for g in [prog.global_params, *window_params]]
    evals = [_eval_gap(pr, prog.global_params, prog.eval_logits)]
    if window_logits is not None:
        evals.append(_eval_gap(pr, window_params[-1], window_logits))
    out = {"loss": loss, "grad1": grad1, "local": local, "round": max(rounds),
           "eval": max(evals)}
    if window_params:
        # the window's share of the last two, for the record; judged above
        out.update(round_window=max(rounds[1:]), eval_window=max(evals[1:], default=None))
    return out
