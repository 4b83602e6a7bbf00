"""Graph container for the port — CSR-first, numpy only.

The serving slice's copy of ``repro/graphs/graph.py``: the canonical
encoding is CSR ``indptr``/``indices`` (O(N + E)) plus the padded neighbour
lists ``nbr_idx``/``nbr_mask`` (N, B) that the layers and the CUDA kernel
read. ``B`` is the padded max degree; self-loops are part of every
neighbourhood. The lazily derived dense (N, N) view of the reference is not
carried over: nothing in the port reads it. ``subgraph`` serves the
federated partition's per-client extraction.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np


class Graph(NamedTuple):
    features: np.ndarray      # (N, d) float32
    labels: np.ndarray        # (N,)   int32
    indptr: np.ndarray        # (N+1,) int64 CSR row pointers (self-loops in)
    indices: np.ndarray       # (nnz,) int32 CSR column ids, sorted per row
    nbr_idx: np.ndarray       # (N, B) int32, padded with 0
    nbr_mask: np.ndarray      # (N, B) bool
    train_mask: np.ndarray    # (N,) bool
    val_mask: np.ndarray      # (N,) bool
    test_mask: np.ndarray     # (N,) bool
    num_classes: int

    @property
    def num_nodes(self) -> int:
        return int(self.features.shape[0])

    @property
    def feature_dim(self) -> int:
        return int(self.features.shape[1])

    @property
    def max_degree(self) -> int:
        return int(self.nbr_idx.shape[1])

    @property
    def nnz(self) -> int:
        """Stored CSR entries (directed slots, self-loops included)."""
        return int(self.indices.shape[0])

    def degrees(self) -> np.ndarray:
        """(N,) int64 CSR row degrees (self-loops included)."""
        return np.diff(self.indptr)


# --------------------------------------------------------------------------
# CSR construction
# --------------------------------------------------------------------------

def pad_degree(deg: int, multiple: int = 8) -> int:
    """Pad max degree up to a multiple."""
    return int(-(-deg // multiple) * multiple)


def sorted_unique(a: np.ndarray) -> np.ndarray:
    """The sorted distinct values of a 1-D array, as ``np.unique`` gives
    them, by one sort. Recent numpy releases take a hash table for integer
    ``np.unique``, which at 1e7 keys runs tens of times slower than this."""
    a = np.sort(np.asarray(a).reshape(-1))
    keep = np.empty(a.shape, dtype=bool)
    keep[:1] = True
    np.not_equal(a[1:], a[:-1], out=keep[1:])
    return a[keep]


def edges_to_csr(
    edges: np.ndarray,
    num_nodes: int,
    *,
    add_self_loops: bool = True,
    symmetrize: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """(E, 2) edge list -> deduplicated CSR ``(indptr, indices)``.

    O(E log E) (one sort), never materialises anything N x N. Endpoints are
    validated against ``[0, num_nodes)``; duplicate edges collapse; indices
    come out sorted within each row.
    """
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if e.size and (e.min() < 0 or e.max() >= num_nodes):
        raise ValueError(
            f"edge endpoints must be in [0, {num_nodes}), got "
            f"[{e.min()}, {e.max()}]"
        )
    src, dst = e[:, 0], e[:, 1]
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    if add_self_loops:
        loop = np.arange(num_nodes, dtype=np.int64)
        src, dst = np.concatenate([src, loop]), np.concatenate([dst, loop])
    keys = sorted_unique(src * num_nodes + dst)
    rows = keys // num_nodes
    indices = (keys % num_nodes).astype(np.int32)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=num_nodes), out=indptr[1:])
    return indptr, indices


def dense_to_csr(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Dense (N, N) bool -> CSR, rows as given (no symmetrize/self-loop)."""
    adj = np.asarray(adj).astype(bool)
    n = adj.shape[0]
    rows, cols = np.nonzero(adj)          # row-major: sorted per row
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr, cols.astype(np.int32)


def csr_to_padded(
    indptr: np.ndarray,
    indices: np.ndarray,
    pad_multiple: int = 8,
    max_degree: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR -> padded ``(nbr_idx, nbr_mask)``, vectorised. Each row keeps its
    first ``B`` neighbours (ascending id)."""
    n = indptr.shape[0] - 1
    degs = np.diff(indptr)
    B = int(degs.max()) if (max_degree is None and n) else int(max_degree or 1)
    B = pad_degree(max(B, 1), pad_multiple)
    take = np.minimum(degs, B)
    col = np.arange(B, dtype=np.int64)[None, :]
    nbr_mask = col < take[:, None]
    pos = indptr[:-1, None] + col
    if indices.size:
        gathered = indices[np.minimum(pos, indices.size - 1)]
    else:
        gathered = np.zeros((n, B), dtype=np.int32)
    nbr_idx = np.where(nbr_mask, gathered, 0).astype(np.int32)
    return nbr_idx, nbr_mask


# --------------------------------------------------------------------------
# Graph constructors
# --------------------------------------------------------------------------

def _graph_from_csr(
    features: np.ndarray,
    labels: np.ndarray,
    indptr: np.ndarray,
    indices: np.ndarray,
    train_mask: np.ndarray,
    val_mask: np.ndarray,
    test_mask: np.ndarray,
    num_classes: int,
    pad_multiple: int = 8,
    max_degree: Optional[int] = None,
) -> Graph:
    nbr_idx, nbr_mask = csr_to_padded(indptr, indices, pad_multiple, max_degree)
    return Graph(
        features=np.asarray(features, dtype=np.float32),
        labels=np.asarray(labels, dtype=np.int32),
        indptr=np.asarray(indptr, dtype=np.int64),
        indices=np.asarray(indices, dtype=np.int32),
        nbr_idx=nbr_idx,
        nbr_mask=nbr_mask,
        train_mask=np.asarray(train_mask, dtype=bool),
        val_mask=np.asarray(val_mask, dtype=bool),
        test_mask=np.asarray(test_mask, dtype=bool),
        num_classes=int(num_classes),
    )


def make_graph_from_edges(
    features: np.ndarray,
    labels: np.ndarray,
    edges: np.ndarray,
    train_mask: np.ndarray,
    val_mask: np.ndarray,
    test_mask: np.ndarray,
    num_classes: int,
    pad_multiple: int = 8,
) -> Graph:
    """Build a :class:`Graph` from an (E, 2) edge list — symmetrised,
    self-loops folded, O(N + E log E), no dense (N, N) anywhere."""
    n = int(np.asarray(features).shape[0])
    indptr, indices = edges_to_csr(np.asarray(edges), n)
    return _graph_from_csr(
        features, labels, indptr, indices,
        train_mask, val_mask, test_mask, num_classes, pad_multiple,
    )


def make_graph(
    features: np.ndarray,
    labels: np.ndarray,
    adj: np.ndarray,
    train_mask: np.ndarray,
    val_mask: np.ndarray,
    test_mask: np.ndarray,
    num_classes: int,
    pad_multiple: int = 8,
) -> Graph:
    """Dense-adjacency constructor (small graphs): the input is symmetrised
    and self-loops folded, then converted to CSR once."""
    adj = np.asarray(adj).astype(bool).copy()
    np.fill_diagonal(adj, True)  # self-loops
    adj = adj | adj.T
    indptr, indices = dense_to_csr(adj)
    return _graph_from_csr(
        features, labels, indptr, indices,
        train_mask, val_mask, test_mask, num_classes, pad_multiple,
    )


# --------------------------------------------------------------------------
# CSR derivations
# --------------------------------------------------------------------------

def edge_list(g: Graph, *, include_self_loops: bool = False) -> np.ndarray:
    """(E, 2) undirected edge list (each edge once, i < j) from the CSR
    encoding; self-loops optionally appended as (i, i) rows. O(E)."""
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees())
    cols = g.indices.astype(np.int64)
    keep = rows < cols
    e = np.stack([rows[keep], cols[keep]], axis=1)
    if include_self_loops:
        loops = rows[rows == cols]
        e = np.concatenate([e, np.stack([loops, loops], axis=1)], axis=0)
    return e


def sample_neighbors(
    g: Graph, max_degree: int, seed: int = 0, pad_multiple: int = 8
) -> Graph:
    """Degree-capped neighbour sampling: every node keeps its self-loop
    plus a uniform random subset of at most ``max_degree - 1`` other
    neighbours, deterministic under ``seed``. The result is a directed
    capped view; its padded degree is ``max_degree`` rounded up to
    ``pad_multiple``."""
    if max_degree < 1:
        raise ValueError(f"max_degree must be >= 1, got {max_degree}")
    n = g.num_nodes
    degs = g.degrees()
    rows = np.repeat(np.arange(n, dtype=np.int64), degs)
    rng = np.random.default_rng(seed)
    pri = rng.random(g.nnz)
    pri[g.indices == rows] = -1.0         # self-loops always survive the cap
    order = np.lexsort((pri, rows))       # grouped by row, priority ascending
    rank_sorted = np.arange(g.nnz, dtype=np.int64) - np.repeat(
        g.indptr[:-1], degs
    )
    keep = np.zeros(g.nnz, dtype=bool)
    keep[order] = rank_sorted < max_degree
    new_indices = g.indices[keep]         # original (ascending) order kept
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=n), out=new_indptr[1:])
    return _graph_from_csr(
        g.features, g.labels, new_indptr, new_indices,
        g.train_mask, g.val_mask, g.test_mask, g.num_classes,
        pad_multiple, max_degree=max_degree,
    )


def subgraph(g: Graph, nodes, pad_multiple: int = 8) -> Graph:
    """Induced subgraph over ``nodes`` (cross-boundary edges dropped),
    CSR-based — O(E + |nodes|), no dense intermediates. The per-client
    subgraph extraction of the federated partition builds on it."""
    nodes = np.asarray(sorted(nodes), dtype=np.int64)
    lookup = np.full(g.num_nodes, -1, dtype=np.int64)
    lookup[nodes] = np.arange(len(nodes))
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees())
    cols = g.indices.astype(np.int64)
    keep = (lookup[rows] >= 0) & (lookup[cols] >= 0) & (rows < cols)
    edges = np.stack([lookup[rows[keep]], lookup[cols[keep]]], axis=1)
    return make_graph_from_edges(
        g.features[nodes],
        g.labels[nodes],
        edges,
        g.train_mask[nodes],
        g.val_mask[nodes],
        g.test_mask[nodes],
        g.num_classes,
        pad_multiple,
    )
