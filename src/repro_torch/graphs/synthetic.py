"""Synthetic citation-style datasets (copy of ``repro/graphs/synthetic.py``).

The generators are the reference's numpy code, so the same seed gives
bit-identical graphs in both packages.

Cora/Citeseer/Pubmed are not bundled with the repository, so the
stand-ins are stochastic-block-model graphs whose statistics (node count
scale, feature dim, class count, homophily, degree) follow the originals.

Feature model: class-conditional sparse binary "bag of words" — each class
draws a signature set of active words; node features are noisy samples of
their class signature, L2-normalised (paper Assumption 3).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.graphs.graph import (
    Graph,
    make_graph,
    make_graph_from_edges,
    sample_neighbors,
)

# name -> (N, d, classes, p_in, p_out, keep, noise, train_per_class, val, test)
# ``keep``/``noise`` control feature informativeness: low keep + high noise
# makes features weak so the GRAPH carries the class signal — that is what
# separates edge-keeping methods (FedGAT) from edge-dropping ones (DistGAT),
# as in the paper's real citation graphs.
DATASET_PRESETS: Dict[str, tuple] = {
    # Small stand-ins; ratios follow the originals.
    "cora_like": (320, 48, 7, 0.10, 0.004, 0.25, 0.15, 6, 60, 140),
    "citeseer_like": (360, 64, 6, 0.09, 0.004, 0.25, 0.15, 6, 60, 140),
    "pubmed_like": (480, 40, 3, 0.07, 0.003, 0.30, 0.15, 8, 80, 180),
    "tiny": (48, 16, 3, 0.35, 0.02, 0.70, 0.05, 4, 8, 16),
}


def make_cora_like(
    name: str = "cora_like",
    seed: int = 0,
    pad_multiple: int = 8,
) -> Graph:
    if name not in DATASET_PRESETS:
        raise KeyError(f"unknown dataset preset {name!r}; have {sorted(DATASET_PRESETS)}")
    N, d, C, p_in, p_out, keep_p, noise_p, n_train, n_val, n_test = DATASET_PRESETS[name]
    rng = np.random.default_rng(seed)

    labels = rng.integers(0, C, size=N).astype(np.int32)

    # --- SBM edges (homophilous) ---
    same = labels[:, None] == labels[None, :]
    probs = np.where(same, p_in, p_out)
    upper = np.triu(rng.random((N, N)) < probs, k=1)
    adj = upper | upper.T

    # --- class-signature bag-of-words features ---
    words_per_class = max(3, d // (C + 1))
    signatures = np.zeros((C, d), dtype=np.float32)
    for c in range(C):
        idx = rng.choice(d, size=words_per_class, replace=False)
        signatures[c, idx] = 1.0
    keep = rng.random((N, d)) < keep_p         # word dropout
    noise = (rng.random((N, d)) < noise_p).astype(np.float32)  # background words
    feats = signatures[labels] * keep + noise
    norms = np.linalg.norm(feats, axis=1, keepdims=True)
    feats = feats / np.maximum(norms, 1e-6)    # Assumption 3: unit norm

    # --- splits: fixed-size per-class train set, then val/test ---
    train_mask = np.zeros(N, dtype=bool)
    for c in range(C):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        train_mask[idx[:n_train]] = True
    rest = np.nonzero(~train_mask)[0]
    rng.shuffle(rest)
    val_mask = np.zeros(N, dtype=bool)
    test_mask = np.zeros(N, dtype=bool)
    val_mask[rest[:n_val]] = True
    test_mask[rest[n_val : n_val + n_test]] = True

    return make_graph(feats, labels, adj, train_mask, val_mask, test_mask, C, pad_multiple)


# ---------------------------------------------------------------------------
# O(E) blocked SBM sampler — the large-graph path
# ---------------------------------------------------------------------------

# name -> (N, d, classes, avg_deg_in, avg_deg_out, keep, noise,
#          train_per_class, val, test, degree_cap)
# Degrees are specified as expected intra/inter-class degree (scale-free in
# N), so every preset lands at avg degree <= 16 whatever its node count —
# the social/merchant-graph regime from the paper's abstract. ``degree_cap``
# (None = uncapped) routes through ``sample_neighbors`` so the padded B of
# huge graphs is bounded even in the Poisson tail.
SBM_PRESETS: Dict[str, tuple] = {
    "sbm_1k": (1_000, 32, 8, 8.0, 2.0, 0.25, 0.15, 20, 200, 400, None),
    "sbm_10k": (10_000, 32, 10, 8.0, 2.0, 0.25, 0.15, 20, 1_000, 2_000, 16),
    "sbm_100k": (100_000, 32, 16, 9.0, 3.0, 0.25, 0.15, 40, 5_000, 10_000, 16),
    "sbm_1m": (1_000_000, 16, 20, 9.0, 3.0, 0.25, 0.15, 60, 20_000, 40_000, 16),
}


def _sample_block_edges(
    rng: np.random.Generator,
    nodes_a: np.ndarray,
    nodes_b: Optional[np.ndarray],
    p: float,
) -> Optional[np.ndarray]:
    """Edges of one SBM block in O(edges-of-the-block).

    Instead of flipping a coin per pair (O(n_a * n_b)), draw the Bernoulli
    *count* m ~ Binomial(#pairs, p) and place m edges uniformly at random.
    Collisions/self-pairs are dropped (and duplicates collapse later in the
    CSR dedup) — an O(p) relative undercount, irrelevant for the sparse
    regime (p ~ deg/N) this generator exists for.
    """
    if p <= 0.0:
        return None
    na = len(nodes_a)
    if nodes_b is None:                    # within-block: unordered pairs
        pairs = na * (na - 1) // 2
        if pairs <= 0:
            return None
        m = rng.binomial(pairs, min(p, 1.0))
        if m == 0:
            return None
        i = nodes_a[rng.integers(0, na, size=m)]
        j = nodes_a[rng.integers(0, na, size=m)]
        keep = i != j
        return np.stack([i[keep], j[keep]], axis=1)
    nb = len(nodes_b)
    pairs = na * nb
    if pairs <= 0:
        return None
    m = rng.binomial(pairs, min(p, 1.0))
    if m == 0:
        return None
    i = nodes_a[rng.integers(0, na, size=m)]
    j = nodes_b[rng.integers(0, nb, size=m)]
    return np.stack([i, j], axis=1)


def make_sbm(
    name: str = "sbm_100k",
    seed: int = 0,
    pad_multiple: int = 8,
) -> Graph:
    """Stochastic-block-model graph at social-graph scale, O(N + E) end to
    end: blocked binomial edge sampling (no (N, N) coin matrix), class-
    signature bag-of-words features, CSR/neighbour-list encodings only.

    ``sbm_100k`` builds a 1e5-node, avg-degree-<=16 graph in a few seconds;
    ``sbm_1m`` is the million-node benchmark preset.
    """
    if name not in SBM_PRESETS:
        raise KeyError(f"unknown SBM preset {name!r}; have {sorted(SBM_PRESETS)}")
    (N, d, C, deg_in, deg_out, keep_p, noise_p,
     n_train, n_val, n_test, degree_cap) = SBM_PRESETS[name]
    rng = np.random.default_rng(seed)

    labels = rng.integers(0, C, size=N).astype(np.int32)
    by_class = [np.nonzero(labels == c)[0] for c in range(C)]

    # --- edges: one binomial draw per class-pair block ---
    # Expected degrees -> block probabilities: a node sees ~n_c * p_in
    # same-class and ~(N - n_c) * p_out cross-class neighbours.
    blocks = []
    for c1 in range(C):
        n_c = max(len(by_class[c1]), 1)
        p_in = min(deg_in / n_c, 1.0)
        blocks.append(_sample_block_edges(rng, by_class[c1], None, p_in))
        for c2 in range(c1 + 1, C):
            p_out = min(deg_out / max(N - n_c, 1), 1.0)
            blocks.append(
                _sample_block_edges(rng, by_class[c1], by_class[c2], p_out)
            )
    blocks = [b for b in blocks if b is not None and len(b)]
    edges = (
        np.concatenate(blocks, axis=0)
        if blocks else np.zeros((0, 2), dtype=np.int64)
    )

    # --- class-signature bag-of-words features (same model as the citation
    # stand-ins, float32 RNG so the 1e6-node preset stays in budget) ---
    words_per_class = max(3, d // (C + 1))
    signatures = np.zeros((C, d), dtype=np.float32)
    for c in range(C):
        idx = rng.choice(d, size=words_per_class, replace=False)
        signatures[c, idx] = 1.0
    keep = rng.random((N, d), dtype=np.float32) < keep_p
    noise = (rng.random((N, d), dtype=np.float32) < noise_p).astype(np.float32)
    feats = signatures[labels] * keep + noise
    norms = np.linalg.norm(feats, axis=1, keepdims=True)
    feats = (feats / np.maximum(norms, 1e-6)).astype(np.float32)

    # --- splits: fixed-size per-class train set, then val/test ---
    train_mask = np.zeros(N, dtype=bool)
    for c in range(C):
        idx = by_class[c].copy()
        rng.shuffle(idx)
        train_mask[idx[:n_train]] = True
    rest = np.nonzero(~train_mask)[0]
    rng.shuffle(rest)
    val_mask = np.zeros(N, dtype=bool)
    test_mask = np.zeros(N, dtype=bool)
    val_mask[rest[:n_val]] = True
    test_mask[rest[n_val : n_val + n_test]] = True

    g = make_graph_from_edges(
        feats, labels, edges, train_mask, val_mask, test_mask, C, pad_multiple
    )
    if degree_cap is not None:
        g = sample_neighbors(g, degree_cap, seed=seed, pad_multiple=pad_multiple)
    return g
