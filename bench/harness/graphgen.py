"""The benchmark's graph generator: a stochastic block model at a public
dataset's published statistics, made from a seed on the host.

A frozen copy of the program's large-graph sampler
(``src/repro_torch/graphs/synthetic.py:106-217``: ``_sample_block_edges``
and ``make_sbm``'s block loop and class-signature feature model), driven
by a configuration's ``graph`` section instead of a preset: the node
count, feature width, class count and undirected edge count are the
dataset's, the edge homophily and the feature model's word keep and noise
rates are assumed, and the split sizes are the dataset's, drawn at random.
Features are L2-normalised rows (the paper's Assumption 3).

Every seed gives the same sizes: N, d, C and the splits are fixed and the
edge count varies only by its binomial draws, so two seeds ask the
program for the same work.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _sample_block_edges(rng: np.random.Generator, nodes_a: np.ndarray,
                        nodes_b: Optional[np.ndarray], p: float) -> Optional[np.ndarray]:
    """Edges of one SBM block in O(edges of the block): a binomial count of
    pairs placed uniformly; self-pairs dropped, duplicates collapse later."""
    if p <= 0.0:
        return None
    na = len(nodes_a)
    if nodes_b is None:
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


def make_graph_inputs(spec: Dict, seed: int) -> Dict[str, np.ndarray]:
    """``{"features", "labels", "edges", "train_mask", "val_mask",
    "test_mask"}`` for the configuration's ``graph`` section ``spec``:
    ``num_nodes``, ``feature_dim``, ``num_classes``, ``undirected_edges``,
    ``edge_homophily``, ``word_keep``, ``word_noise`` and ``splits``
    (train, val, test sizes)."""
    N, d, C = int(spec["num_nodes"]), int(spec["feature_dim"]), int(spec["num_classes"])
    mean_degree = 2.0 * float(spec["undirected_edges"]) / N
    deg_in = float(spec["edge_homophily"]) * mean_degree
    deg_out = mean_degree - deg_in
    rng = np.random.default_rng(seed)

    labels = rng.integers(0, C, size=N).astype(np.int32)
    by_class = [np.nonzero(labels == c)[0] for c in range(C)]
    blocks = []
    for c1 in range(C):
        n_c = max(len(by_class[c1]), 1)
        blocks.append(_sample_block_edges(rng, by_class[c1], None, min(deg_in / n_c, 1.0)))
        for c2 in range(c1 + 1, C):
            p_out = min(deg_out / max(N - n_c, 1), 1.0)
            blocks.append(_sample_block_edges(rng, by_class[c1], by_class[c2], p_out))
    blocks = [b for b in blocks if b is not None and len(b)]
    edges = np.concatenate(blocks, axis=0) if blocks else np.zeros((0, 2), dtype=np.int64)

    words_per_class = max(3, d // (C + 1))
    signatures = np.zeros((C, d), dtype=np.float32)
    for c in range(C):
        signatures[c, rng.choice(d, size=words_per_class, replace=False)] = 1.0
    keep = rng.random((N, d), dtype=np.float32) < float(spec["word_keep"])
    noise = (rng.random((N, d), dtype=np.float32) < float(spec["word_noise"])).astype(np.float32)
    feats = signatures[labels] * keep + noise
    norms = np.linalg.norm(feats, axis=1, keepdims=True)
    feats = (feats / np.maximum(norms, 1e-6)).astype(np.float32)

    n_train, n_val, n_test = (int(s) for s in spec["splits"])
    if n_train + n_val + n_test > N:
        raise ValueError("graph splits exceed the node count")
    order = rng.permutation(N)
    masks = []
    for lo, hi in ((0, n_train), (n_train, n_train + n_val),
                   (n_train + n_val, n_train + n_val + n_test)):
        m = np.zeros(N, dtype=bool)
        m[order[lo:hi]] = True
        masks.append(m)
    return {"features": feats, "labels": labels, "edges": edges,
            "train_mask": masks[0], "val_mask": masks[1], "test_mask": masks[2]}
