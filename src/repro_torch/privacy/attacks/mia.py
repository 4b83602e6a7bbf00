"""Node membership inference against a trained federated model.

The port of ``repro/privacy/attacks/mia.py``. Train a model, score every
node by its per-node loss or true-class confidence, and predict "training
member" when the score clears a threshold; the attack's *advantage* (max
over thresholds of TPR - FPR) measures realised leakage.

  * :func:`threshold_attack` — the oracle threshold, maximising advantage
    on the evaluation split itself.
  * :func:`shadow_attack` — the threshold calibrated on *shadow* models
    (same pipeline, other seeds), then applied blind to the target model.

The scoring and attack functions are numpy plus torch's ``log_softmax``;
the harness trains through the port's :class:`Trainer` on ``device``.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device

SCORES = ("loss", "confidence")


def node_scores(logits: Any, labels: Any) -> Dict[str, np.ndarray]:
    """Per-node cross-entropy loss and true-class confidence.

    Returns host float64 arrays keyed "loss" and "confidence"; the
    attacks consume one of them (oriented so higher = more member-like:
    confidence as-is, loss negated).
    """
    lg = torch.as_tensor(logits).detach().cpu()
    lb = torch.as_tensor(np.asarray(labels), dtype=torch.int64)
    logp = torch.log_softmax(lg, dim=-1)
    true_logp = torch.take_along_dim(logp, lb[:, None], dim=-1)[:, 0]
    return {
        "loss": np.asarray(-true_logp, np.float64),
        "confidence": np.asarray(torch.exp(true_logp), np.float64),
    }


def _member_oriented(scores: np.ndarray, score: str) -> np.ndarray:
    if score not in SCORES:
        raise ValueError(f"score must be one of {SCORES}, got {score!r}")
    s = np.asarray(scores, np.float64)
    return -s if score == "loss" else s


def attack_curve(
    member: np.ndarray, nonmember: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(thresholds, TPR, FPR) of the rule "member iff score >= t".

    Scores must already be member-oriented (higher = member-like).
    """
    m = np.asarray(member, np.float64)
    n = np.asarray(nonmember, np.float64)
    if m.size == 0 or n.size == 0:
        raise ValueError("both member and nonmember score sets must be non-empty")
    thr = np.unique(np.concatenate([m, n]))
    tpr = (m[None, :] >= thr[:, None]).mean(axis=1)
    fpr = (n[None, :] >= thr[:, None]).mean(axis=1)
    return thr, tpr, fpr


def _auc(member: np.ndarray, nonmember: np.ndarray) -> float:
    """Mann-Whitney AUC (tie-corrected): P(member score > nonmember) +
    1/2 P(equal)."""
    m = np.asarray(member, np.float64)
    n = np.asarray(nonmember, np.float64)
    allv = np.concatenate([m, n])
    order = np.argsort(allv, kind="mergesort")
    ranks = np.empty_like(allv)
    ranks[order] = np.arange(1, allv.size + 1, dtype=np.float64)
    # average ranks over ties
    uniq, inv, counts = np.unique(allv, return_inverse=True, return_counts=True)
    sums = np.zeros(uniq.size)
    np.add.at(sums, inv, ranks)
    ranks = (sums / counts)[inv]
    u = ranks[: m.size].sum() - m.size * (m.size + 1) / 2.0
    return float(u / (m.size * n.size))


def threshold_attack(
    member: np.ndarray, nonmember: np.ndarray, score: str = "loss"
) -> Dict[str, float]:
    """Oracle-threshold membership inference on raw per-node scores.

    ``member`` / ``nonmember`` are raw scores of the chosen ``score``
    kind; orientation is handled here. Returns advantage (max TPR - FPR),
    AUC, and the maximising threshold (in member-oriented units).
    """
    m = _member_oriented(member, score)
    n = _member_oriented(nonmember, score)
    thr, tpr, fpr = attack_curve(m, n)
    i = int(np.argmax(tpr - fpr))
    return {
        "advantage": float(tpr[i] - fpr[i]),
        "auc": _auc(m, n),
        "threshold": float(thr[i]),
        "tpr": float(tpr[i]),
        "fpr": float(fpr[i]),
    }


def calibrated_attack(
    member: np.ndarray,
    nonmember: np.ndarray,
    threshold: float,
    score: str = "loss",
) -> Dict[str, float]:
    """Evaluate the fixed (shadow-calibrated) threshold on target scores."""
    m = _member_oriented(member, score)
    n = _member_oriented(nonmember, score)
    tpr = float((m >= threshold).mean())
    fpr = float((n >= threshold).mean())
    return {"advantage": tpr - fpr, "tpr": tpr, "fpr": fpr,
            "threshold": float(threshold)}


# ---------------------------------------------------------------------------
# End-to-end harness: train -> score -> attack
# ---------------------------------------------------------------------------


def _trained_scores(g: Any, cfg: Any, device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Train ``cfg`` on ``g`` and return every node's scores.

    The forward pass is rebuilt as the Trainer builds it (the same pack
    generator and pack noise), so the attacked logits are the model the
    run released.
    """
    from repro_torch.federated.trainer import Trainer, build_forward, param_tree

    dev = resolve_device(device)
    res = Trainer(cfg, device=dev).run(g)
    _, forward = build_forward(cfg, g, dev)
    with torch.inference_mode():
        logits = forward(param_tree(res["params"]),
                         torch.as_tensor(g.nbr_mask, device=dev))
    scores = node_scores(logits, g.labels)
    scores["_result"] = res
    return scores


def _split_scores(
    g: Any, scores: Dict[str, np.ndarray], score: str
) -> Tuple[np.ndarray, np.ndarray]:
    members = np.asarray(g.train_mask) > 0
    nonmembers = np.asarray(g.test_mask) > 0
    return scores[score][members], scores[score][nonmembers]


def run_membership_inference(
    g: Any, cfg: Any, score: str = "loss", *, device: DeviceLike = None
) -> Dict[str, Any]:
    """Oracle-threshold audit of one training config on one graph.

    Members are the training nodes, nonmembers the test nodes. Returns the
    attack numbers plus the run's quality metrics and privacy report.
    """
    scores = _trained_scores(g, cfg, device)
    res = scores.pop("_result")
    member, nonmember = _split_scores(g, scores, score)
    out = threshold_attack(member, nonmember, score)
    out.update(
        score=score,
        n_members=int(member.size),
        n_nonmembers=int(nonmember.size),
        member_mean=float(member.mean()),
        nonmember_mean=float(nonmember.mean()),
        best_test=res["best_test"],
        final_test=res["final_test"],
        privacy=res["privacy"],
    )
    return out


def shadow_attack(
    g: Any, cfg: Any, shadow_seeds: Sequence[int] = (1, 2), score: str = "loss",
    *, device: DeviceLike = None,
) -> Dict[str, Any]:
    """Shadow-calibrated membership inference: one shadow model per seed
    with the target's config, their pooled scores pick the threshold, which
    is then applied to the target model."""
    from dataclasses import replace

    if any(int(s) == cfg.seed for s in shadow_seeds):
        raise ValueError("shadow seeds must differ from the target seed")
    sm, sn = [], []
    for s in shadow_seeds:
        scores = _trained_scores(g, replace(cfg, seed=int(s)), device)
        scores.pop("_result")
        m, n = _split_scores(g, scores, score)
        sm.append(m)
        sn.append(n)
    shadow = threshold_attack(np.concatenate(sm), np.concatenate(sn), score)

    target_scores = _trained_scores(g, cfg, device)
    target_scores.pop("_result")
    member, nonmember = _split_scores(g, target_scores, score)
    out = calibrated_attack(member, nonmember, shadow["threshold"], score)
    return {
        "advantage": out["advantage"],
        "tpr": out["tpr"],
        "fpr": out["fpr"],
        "threshold": shadow["threshold"],
        "shadow_advantage": shadow["advantage"],
        "oracle": threshold_attack(member, nonmember, score),
        "score": score,
        "n_shadow_models": len(list(shadow_seeds)),
    }
