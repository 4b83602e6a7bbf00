"""Incremental graph updates for the inference server.

The port of ``GraphDelta``/``apply_delta`` from ``repro/serving/updates.py``.
New nodes and edges arrive as :class:`GraphDelta`s; :func:`apply_delta`
builds the grown graph. The engines of this package carry no pack and
re-read the graph arrays on every forward, so a delta is absorbed exactly.
Pack patching and drift tracking wait for the pack-building engines.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.graphs.graph import Graph, edge_list, make_graph_from_edges


class GraphDelta(NamedTuple):
    """A batch of graph updates: new nodes (features/labels) and new edges.

    ``edges`` endpoints index the GROWN node set (old nodes keep their ids,
    new nodes are appended), so an edge may connect old-old, old-new or
    new-new pairs. (The reference's ``owners`` field serves the DistGAT
    method, which this package does not serve yet.)
    """

    features: Optional[np.ndarray] = None    # (M, d) float
    labels: Optional[np.ndarray] = None      # (M,) int; default 0
    edges: Optional[np.ndarray] = None       # (E, 2) int

    @property
    def num_new_nodes(self) -> int:
        return 0 if self.features is None else int(np.asarray(self.features).shape[0])

    @property
    def num_new_edges(self) -> int:
        return 0 if self.edges is None else int(np.asarray(self.edges).reshape(-1, 2).shape[0])


def apply_delta(g: Graph, delta: GraphDelta, pad_multiple: int = 8) -> Graph:
    """The updated graph: nodes appended, edges added, neighbour lists
    rebuilt (new nodes join the val/test/train splits as unlabeled serving
    nodes — all split masks False).

    Edge-list based throughout: the old graph contributes ``edge_list(g)``,
    the delta its new pairs, and the CSR build dedups/symmetrises — a delta
    on a 1e5-node graph costs O(N + E), never an (N, N) array.
    """
    n_old = g.num_nodes
    m = delta.num_new_nodes
    if m:
        feats_new = np.asarray(delta.features, np.float32).reshape(m, -1)
        if feats_new.shape[1] != g.feature_dim:
            raise ValueError(
                f"delta features have dim {feats_new.shape[1]}, graph has {g.feature_dim}"
            )
        labels_new = (
            np.zeros(m, np.int32) if delta.labels is None
            else np.asarray(delta.labels, np.int32).reshape(m)
        )
        features = np.concatenate([g.features, feats_new], axis=0)
        labels = np.concatenate([g.labels, labels_new], axis=0)
    else:
        features, labels = g.features, g.labels
    n_new = n_old + m

    old_edges = edge_list(g)
    if delta.num_new_edges:
        new_edges = np.asarray(delta.edges, np.int64).reshape(-1, 2)
        if new_edges.min() < 0 or new_edges.max() >= n_new:
            raise ValueError(
                f"delta edge endpoints must be in [0, {n_new}), got "
                f"[{new_edges.min()}, {new_edges.max()}]"
            )
        edges = np.concatenate([old_edges, new_edges], axis=0)
    else:
        edges = old_edges

    def _grow(mask: np.ndarray) -> np.ndarray:
        return np.concatenate([mask, np.zeros(m, dtype=bool)], axis=0)

    return make_graph_from_edges(
        features, labels, edges,
        _grow(g.train_mask), _grow(g.val_mask), _grow(g.test_mask),
        g.num_classes, pad_multiple,
    )
