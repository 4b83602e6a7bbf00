"""Graph partitioning across federated clients — CSR-based.

The port of ``repro/federated/partition.py`` (numpy only, bit-identical on
the same seed).

Follows the paper's experimental setup: nodes are assigned to K clients with
a Dirichlet(beta) label distribution (Hsu, Qi & Brown 2019) — beta=1 is the
paper's "non-iid" setting, beta=10000 its "iid" setting. Cross-client edges
are the edges whose endpoints land on different clients; FedGAT keeps them
(via the pre-training pack), DistGAT drops them.

Everything here runs on the CSR edge lists: halo/frontier expansion is an
O(E) scatter per hop (no ``adj @ frontier`` matmul), cross-client edges are
counted from the edge list, and per-client subgraphs (local node set +
L-hop halo) extract without any (N, N) or (K, N) dense intermediate — the
primitives the multi-process data placement loads from.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.graphs.graph import Graph, subgraph as induced_subgraph


class Partition(NamedTuple):
    owner: np.ndarray          # (N,) int32 client id per node
    num_clients: int
    beta: float

    def client_nodes(self, k: int) -> np.ndarray:
        return np.nonzero(self.owner == k)[0]


def dirichlet_partition(labels: np.ndarray, num_clients: int, beta: float, seed: int = 0) -> Partition:
    """Assign each node to a client; class c's nodes split ~ Dir(beta)."""
    rng = np.random.default_rng(seed)
    n = labels.shape[0]
    owner = np.zeros(n, dtype=np.int32)
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, beta))
        counts = np.floor(props * len(idx)).astype(int)
        # distribute the remainder round-robin over the largest shares
        rem = len(idx) - counts.sum()
        order = np.argsort(-props)
        for i in range(rem):
            counts[order[i % num_clients]] += 1
        start = 0
        for k in range(num_clients):
            owner[idx[start : start + counts[k]]] = k
            start += counts[k]
    return Partition(owner=owner, num_clients=num_clients, beta=beta)


# ---------------------------------------------------------------------------
# CSR frontier expansion (the halo primitive; no dense matmul)
# ---------------------------------------------------------------------------

def frontier_expand(g: Graph, frontier: np.ndarray) -> np.ndarray:
    """(N,) bool of nodes adjacent to ``frontier`` — one BFS hop over the
    CSR edge list, O(E). Self-loops keep the frontier inside its own
    expansion, matching the old ``(adj @ frontier) > 0`` semantics."""
    frontier = np.asarray(frontier, dtype=bool)
    live = np.repeat(frontier, g.degrees())        # one flag per CSR slot
    out = np.zeros(g.num_nodes, dtype=bool)
    out[g.indices[live]] = True
    return out


def _reach(g: Graph, start: np.ndarray, hops: int) -> np.ndarray:
    reach = np.asarray(start, dtype=bool).copy()
    frontier = reach
    for _ in range(hops):
        frontier = frontier_expand(g, frontier)
        reach = reach | frontier
    return reach


def cross_client_edge_count(g: Graph, part: Partition) -> int:
    """Number of (undirected) edges crossing clients, self-loops excluded;
    O(E) over the CSR edge list. The reference's dense-adjacency form is
    not carried over."""
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees())
    cols = g.indices
    upper = rows < cols                        # each edge once, no loops
    return int(np.sum(part.owner[rows[upper]] != part.owner[cols[upper]]))


def client_neighbor_masks(
    g: Graph, part: Partition, clients: Optional[Sequence[int]] = None
) -> np.ndarray:
    """(K, N, B) neighbour masks for the DistGAT baseline: client k sees only
    edges internal to its node set (self-loops always kept).

    ``clients`` restricts the build to a subset of client ids (rows are
    returned in the given order) — the multi-process backend uses this so
    each process materialises only the clients it hosts.

    A client's mask is nonzero only on rows the client owns, so each mask
    is filled via its owned-row slice — O(n_k * B) per client, O(N * B)
    total over all clients (the old form broadcast O(N * B) per client).
    """
    ids = range(part.num_clients) if clients is None else list(clients)
    masks = np.zeros((len(ids), g.num_nodes, g.max_degree), dtype=bool)
    for i, k in enumerate(ids):
        rows = part.client_nodes(k)
        nb = g.nbr_idx[rows]                               # (n_k, B)
        internal = part.owner[nb] == k
        self_loop = nb == rows[:, None]
        masks[i, rows] = g.nbr_mask[rows] & (internal | self_loop)
    return masks


def client_train_masks(
    g: Graph, part: Partition, clients: Optional[Sequence[int]] = None
) -> np.ndarray:
    """(K, N) training-node masks per client (optionally a client subset)."""
    ids = range(part.num_clients) if clients is None else list(clients)
    return np.stack([(part.owner == k) & g.train_mask for k in ids])


def stage_cohort_masks(
    g: Graph,
    part: Partition,
    client_ids: Sequence[int],
    size: int,
    *,
    neighbor: bool = True,
) -> tuple:
    """Stack ONLY the active cohort's per-client masks — the cohort
    scheduler's staging primitive. Returns ``(nb, tr)``:

      nb — (size, N, B) per-client edge-visibility masks (``None`` when
           ``neighbor=False``: methods whose clients all see the full
           graph pass one shared mask instead of a stacked copy);
      tr — (size, N) per-client training-label masks.

    ``client_ids`` are the cohort's live clients (<= ``size``); the
    remaining padding lanes repeat the first client's rows. Peak staging
    memory is O(size · N · B) regardless of K.
    """
    ids = list(client_ids)
    if not 1 <= len(ids) <= size:
        raise ValueError(
            f"cohort has {len(ids)} clients but size {size} lanes"
        )
    pad = size - len(ids)
    tr = client_train_masks(g, part, clients=ids)
    if pad:
        tr = np.concatenate([tr, np.repeat(tr[:1], pad, axis=0)])
    nb = None
    if neighbor:
        nb = client_neighbor_masks(g, part, clients=ids)
        if pad:
            nb = np.concatenate([nb, np.repeat(nb[:1], pad, axis=0)])
    return nb, tr


def l_hop_sizes(g: Graph, part: Partition, L: int) -> np.ndarray:
    """Size of each client's L-hop neighbourhood (paper's B_L statistic)."""
    K = part.num_clients
    sizes = np.zeros(K, dtype=np.int64)
    for k in range(K):
        sizes[k] = int(_reach(g, part.owner == k, L).sum())
    return sizes


# ---------------------------------------------------------------------------
# Per-client local-subgraph extraction (the per-process loading primitive)
# ---------------------------------------------------------------------------

class ClientSubgraph(NamedTuple):
    """One client's locally loadable slice of the global graph.

    ``graph`` is the induced subgraph over the client's local node set plus
    its ``hops``-hop halo (cross-boundary edges beyond the halo dropped);
    ``nodes`` maps local ids back to global ids; ``local_mask`` flags which
    of those nodes the client actually owns (the halo rows exist only to
    make the owned rows' L-hop aggregations exact).
    """

    graph: Graph
    nodes: np.ndarray          # (n_local,) int64 global node ids
    local_mask: np.ndarray     # (n_local,) bool — owned (non-halo) nodes

    @property
    def num_halo(self) -> int:
        return int((~self.local_mask).sum())


def client_halo_nodes(g: Graph, part: Partition, k: int, hops: int) -> np.ndarray:
    """Sorted global ids of client k's local node set + ``hops``-hop halo,
    via CSR frontier expansion (O(hops * E), no dense matmul)."""
    return np.nonzero(_reach(g, part.owner == k, hops))[0]


def client_subgraph(
    g: Graph, part: Partition, k: int, hops: int = 1, pad_multiple: int = 8
) -> ClientSubgraph:
    """Extract client k's local subgraph (local set + halo) from the CSR
    encoding. This is the per-process data-placement unit: a process hosting
    clients ``ks`` needs only ``client_subgraph(g, part, k)`` for k in ks —
    never the full graph, never anything O(N^2)."""
    nodes = client_halo_nodes(g, part, k, hops)
    sub = induced_subgraph(g, nodes, pad_multiple)
    return ClientSubgraph(
        graph=sub, nodes=nodes, local_mask=part.owner[nodes] == k
    )
