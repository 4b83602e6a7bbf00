"""Incremental graph updates for the inference server.

The port of ``repro/serving/updates.py``. New nodes and edges arrive as
:class:`GraphDelta` streams. Rebuilding a client's pre-communicated pack on
every delta would cost the full O(N d g^2) precompute, so the server
instead applies a *cheap local patch*:

* pack rows are appended for the NEW nodes only (a mini ``precompute`` over
  just those rows, at the pack's existing padded degree), and
* existing nodes' rows are left STALE — edges added to an already-packed
  node are invisible to the pack's moment machinery until a refresh.

The resulting approximation error is tracked explicitly: ``covered``
records exactly which (i -> j) attention slots the current pack encodes,
and :func:`mass_drift` measures the attention mass of the uncovered slots
relative to the covered mass — the eps that the paper's Thm 3.5 chain
(repro_torch.analysis.error_bounds) propagates to a served-logit bound. The
server refreshes a client's pack (a full precompute, bit-identical to a
from-scratch one under the same generator) only when that bound is crossed.

Engines without a pack (``direct``/``kernel``/``exact``) re-read the graph
arrays on every forward, so deltas are absorbed exactly and the tracked
drift stays zero. Coverage is host numpy; packs and the drift's series
evaluation stay on the pack's device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.poly_attention import edge_scores, eval_series, head_projections
from repro_torch.graphs.graph import Graph, edge_list, make_graph_from_edges, sorted_unique


class GraphDelta(NamedTuple):
    """A batch of graph updates: new nodes (features/labels) and new edges.

    ``edges`` endpoints index the GROWN node set (old nodes keep their ids,
    new nodes are appended), so an edge may connect old-old, old-new or
    new-new pairs. ``owners`` optionally assigns new nodes to clients
    (required when serving the DistGAT method, whose visibility is
    per-client).
    """

    features: Optional[np.ndarray] = None    # (M, d) float
    labels: Optional[np.ndarray] = None      # (M,) int; default 0
    edges: Optional[np.ndarray] = None       # (E, 2) int
    owners: Optional[np.ndarray] = None      # (M,) int client ids

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


# ---------------------------------------------------------------------------
# Pack coverage: which attention slots does the (possibly stale) pack encode?
# ---------------------------------------------------------------------------

class Coverage(NamedTuple):
    """Sparse set of directed (i -> j) attention slots the pack encodes.

    ``keys`` holds ``i * num_nodes + j`` for each covered slot, sorted and
    unique — membership is a searchsorted, storage is O(covered slots).
    """

    num_nodes: int
    keys: np.ndarray            # (nnz,) sorted unique int64

    @property
    def num_covered(self) -> int:
        return int(self.keys.shape[0])


def _slot_keys(
    g: Graph, rows: np.ndarray, valid: np.ndarray, num_nodes: int
) -> np.ndarray:
    """int64 keys of the valid (row, neighbour) slots of ``rows``."""
    r, s = np.nonzero(valid[rows])
    return rows[r].astype(np.int64) * num_nodes + g.nbr_idx[rows][r, s]


def initial_coverage(g: Graph, visible_mask: Optional[np.ndarray] = None) -> Coverage:
    """Coverage of a freshly precomputed pack: every (visible) neighbour
    slot. Directional, matching the row-wise attention aggregation."""
    valid = g.nbr_mask if visible_mask is None else (g.nbr_mask & visible_mask)
    rows = np.arange(g.num_nodes)
    keys = _slot_keys(g, rows, valid, g.num_nodes)
    return Coverage(num_nodes=g.num_nodes, keys=sorted_unique(keys))


def extend_coverage(
    cov: Coverage,
    new_graph: Graph,
    b_pack: int,
    visible_mask: Optional[np.ndarray] = None,
) -> Coverage:
    """Coverage after a patch: old slots unchanged (stale), new-node rows
    cover their first ``b_pack`` neighbour slots (the patch's capacity —
    overflow neighbours stay uncovered until a refresh)."""
    n_old = cov.num_nodes
    n_new = new_graph.num_nodes
    i, j = np.divmod(cov.keys, n_old)          # rekey into the grown id space
    old_keys = i * n_new + j
    valid = new_graph.nbr_mask if visible_mask is None else (
        new_graph.nbr_mask & visible_mask
    )
    valid = valid.copy()
    valid[:, b_pack:] = False                  # patch capacity
    rows = np.arange(n_old, n_new)
    new_keys = _slot_keys(new_graph, rows, valid, n_new)
    return Coverage(
        num_nodes=n_new, keys=sorted_unique(np.concatenate([old_keys, new_keys]))
    )


def coverage_lookup(cov: Coverage, nbr_idx: np.ndarray) -> np.ndarray:
    """(N, B) bool: is slot (i, nbr_idx[i, b]) covered? Vectorised
    searchsorted over the sorted key set."""
    n = cov.num_nodes
    q = np.arange(n, dtype=np.int64)[:, None] * n + nbr_idx
    if cov.keys.size == 0:
        return np.zeros(q.shape, dtype=bool)
    pos = np.searchsorted(cov.keys, q)
    pos_c = np.minimum(pos, cov.keys.size - 1)
    return cov.keys[pos_c] == q


# ---------------------------------------------------------------------------
# The cheap local pack patch
# ---------------------------------------------------------------------------

def concat_pack_rows(pack: Any, rows: Any) -> Any:
    """Append per-node pack rows (same NamedTuple type, same padded degree);
    non-tensor fields (e.g. the Matrix pack's ``r``) are kept from ``pack``.
    Allocates the grown pack: the old one is a transient until dropped."""
    if type(pack) is not type(rows):
        raise TypeError(f"pack type mismatch: {type(pack)} vs {type(rows)}")
    return type(pack)(*(
        torch.cat([a, b.to(a.device)], dim=0) if isinstance(a, torch.Tensor) else a
        for a, b in zip(pack, rows)
    ))


def patch_pack(
    engine: Any,
    gen: Optional[torch.Generator],
    pack: Any,
    n_old: int,
    new_graph: Graph,
    b_pack: int,
    visible_mask: Optional[np.ndarray] = None,
) -> Any:
    """Append pack rows for the new nodes ``[n_old, N_new)`` at the pack's
    existing padded degree ``b_pack`` (neighbours beyond that capacity are
    dropped from the patch and show up as uncovered drift). Existing rows
    are untouched — that staleness is the tracked approximation. The rows
    are drawn from ``gen``, on the pack's device."""
    n_new = new_graph.num_nodes
    if pack is None or n_new == n_old:
        return pack
    m = n_new - n_old
    # Engines expect pack row i to align with h[i] while neighbour indices
    # gather anywhere in h — so stack the new nodes' features FIRST (the m
    # pack rows) followed by the full feature table (gather targets), and
    # shift the neighbour ids into that full copy.
    feats = np.asarray(new_graph.features, np.float32)
    h_aug = np.concatenate([feats[n_old:], feats], axis=0)
    idx = new_graph.nbr_idx[n_old:, :b_pack] + m
    mask = new_graph.nbr_mask[n_old:, :b_pack]
    if visible_mask is not None:
        mask = mask & visible_mask[n_old:, :b_pack]
    dev = next(a.device for a in pack if isinstance(a, torch.Tensor))
    with torch.no_grad():
        rows = engine.precompute(
            gen, torch.from_numpy(h_aug).to(dev),
            torch.as_tensor(idx, dtype=torch.int64, device=dev),
            torch.as_tensor(mask, dtype=torch.bool, device=dev),
        )
        return concat_pack_rows(pack, rows)


# ---------------------------------------------------------------------------
# Drift measurement (the eps that feeds the Thm 3.5 chain)
# ---------------------------------------------------------------------------

def mass_drift(
    layer1_params: Any,
    coeffs: torch.Tensor,
    basis: str,
    domain: Tuple[float, float],
    g: Graph,
    covered: Coverage,
    visible_mask: Optional[np.ndarray] = None,
) -> float:
    """Measured relative attention-mass error of serving from a stale pack.

    For every head/node, the series attention mass of the UNCOVERED slots
    (edges the pack does not encode) over the mass of the COVERED slots —
    exactly the score-perturbation eps that Theorem 3 turns into a
    coefficient error. The series is evaluated on the device of
    ``coeffs``; O(H N B p), far cheaper than the O(N d g^2) pack rebuild
    it postpones.

    Monotone between refreshes: the covered set never grows under patches
    (new-node rows enter covered at patch time, before they accrue drift),
    features are immutable, so uncovered mass only accumulates.
    """
    valid = g.nbr_mask if visible_mask is None else (g.nbr_mask & visible_mask)
    cov_slot = coverage_lookup(covered, g.nbr_idx) & valid
    changed = valid & ~cov_slot
    if not changed.any():
        return 0.0
    dev = coeffs.device
    with torch.no_grad():
        h = torch.as_tensor(g.features, dtype=torch.float32, device=dev)
        b1, b2 = head_projections(layer1_params)
        x = edge_scores(b1, b2, h, torch.as_tensor(g.nbr_idx, dtype=torch.int64, device=dev))
        e = eval_series(coeffs.to(torch.float32), x, basis, domain).abs()   # (H, N, B)
        missing = (e * torch.as_tensor(changed, device=dev)).sum(dim=-1)    # (H, N)
        present = (e * torch.as_tensor(cov_slot, device=dev)).sum(dim=-1)
        return float((missing / present.clamp_min(1e-12)).max())
