"""Frozen copies of the rules the program derives its state by.

The reference works out again what the program derives from the
benchmark's inputs: the client partition, the selection schedule, the
client masks, the series coefficients, the capped neighbour lists and
the privacy streams. Each rule below is a copy of the
program's code as it stood when the benchmark was defined, headed by the
``file:line`` it was copied from. The program may change these later; the
yardstick may not. Only numpy and torch are imported.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# src/repro_torch/_rng.py:18-34 -- splitmix64 seed derivation
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def fold_in(seed: int, data: int) -> int:
    return splitmix64(splitmix64(int(seed) & _MASK64) ^ (int(data) & _MASK64))


def cpu_generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(int(seed) & _MASK64)


# ---------------------------------------------------------------------------
# src/repro_torch/privacy/dp.py:37-63 -- the privacy streams' keys
# ---------------------------------------------------------------------------

_PRIVACY_STREAM = 0x0DDD5EED
_NOISE_SUBSTREAM = 0
_MASK_SUBSTREAM = 1


def noise_base_key(seed: int) -> int:
    return fold_in(fold_in(seed, _PRIVACY_STREAM), _NOISE_SUBSTREAM)


def mask_base_key(seed: int) -> int:
    return fold_in(fold_in(seed, _PRIVACY_STREAM), _MASK_SUBSTREAM)


def client_round_key(base: int, round_idx: int, client_id: int) -> int:
    return fold_in(fold_in(base, round_idx), client_id)


# ---------------------------------------------------------------------------
# src/repro_torch/privacy/dp.py:66-105 and src/repro_torch/optim/adamw.py:68-78
# -- DP-FedAvg: clip the client's delta by its global norm, add noise drawn
# leaf by leaf from CPU generators seeded fold_in(key, leaf index)
# ---------------------------------------------------------------------------

def dp_noise_std(noise_multiplier: float, clip: float, num_selected: int) -> float:
    if noise_multiplier <= 0:
        return 0.0
    return noise_multiplier * clip / math.sqrt(max(num_selected, 1))


@torch.no_grad()
def dp_transform(key: int, gleaves: List[torch.Tensor], leaves: List[torch.Tensor],
                 clip: float, std: float) -> List[torch.Tensor]:
    delta = [p - g for p, g in zip(leaves, gleaves)]
    if math.isfinite(clip):
        norm = torch.sqrt(sum(torch.sum(d.to(torch.float32) ** 2) for d in delta))
        scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
        delta = [d * scale for d in delta]
    if std > 0:
        delta = [d + std * torch.randn(d.shape, generator=cpu_generator(fold_in(key, i)),
                                       dtype=d.dtype).to(d.device)
                 for i, d in enumerate(delta)]
    return [g + d for g, d in zip(gleaves, delta)]


# ---------------------------------------------------------------------------
# src/repro_torch/privacy/secure_agg.py:434-472 -- pairwise float masks
# ---------------------------------------------------------------------------

def pair_key(base: int, round_idx: int, i: int, j: int) -> int:
    lo, hi = (i, j) if i < j else (j, i)
    return fold_in(fold_in(fold_in(base, round_idx), lo), hi)


@torch.no_grad()
def client_mask(base: int, round_idx: int, client_id: int, sel_row: np.ndarray,
                leaves: List[torch.Tensor], scale: float) -> List[torch.Tensor]:
    c = int(client_id)
    sel = np.asarray(sel_row, np.float32)
    acc = [torch.zeros(x.shape, dtype=x.dtype) for x in leaves]
    if sel[c] != 0:
        for j in np.nonzero(sel)[0].tolist():
            if j == c:
                continue
            w = float(np.float32(scale) * np.float32(1.0 if c < j else -1.0)
                      * sel[j] * sel[c])
            pk = pair_key(base, round_idx, c, j)
            for i, x in enumerate(leaves):
                acc[i] += w * torch.randn(x.shape, generator=cpu_generator(fold_in(pk, i)),
                                          dtype=x.dtype)
    return [a.to(x.device) for a, x in zip(acc, leaves)]


# ---------------------------------------------------------------------------
# src/repro_torch/federated/partition.py:36-55 -- Dirichlet label partition
# ---------------------------------------------------------------------------

def dirichlet_partition(labels: np.ndarray, num_clients: int, beta: float,
                        seed: int = 0) -> np.ndarray:
    """Returns the owner (N,) int32 of each node."""
    rng = np.random.default_rng(seed)
    n = labels.shape[0]
    owner = np.zeros(n, dtype=np.int32)
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(num_clients, beta))
        counts = np.floor(props * len(idx)).astype(int)
        rem = len(idx) - counts.sum()
        order = np.argsort(-props)
        for i in range(rem):
            counts[order[i % num_clients]] += 1
        start = 0
        for k in range(num_clients):
            owner[idx[start : start + counts[k]]] = k
            start += counts[k]
    return owner


# src/repro_torch/federated/partition.py:117-122 -- a client's training labels
def client_train_mask(owner: np.ndarray, train_mask: np.ndarray, k: int) -> np.ndarray:
    return (owner == k) & train_mask


# ---------------------------------------------------------------------------
# src/repro_torch/federated/trainer.py:273-296 -- Algorithm 2's CS(t)
# ---------------------------------------------------------------------------

def num_selected(client_fraction: float, num_clients: int) -> int:
    n = int(math.floor(client_fraction * num_clients + 0.5))
    return min(num_clients, max(1, n))


def selection_schedule(seed: int, rounds: int, num_clients: int,
                       client_fraction: float) -> Tuple[np.ndarray, np.ndarray]:
    """(sel (rounds, K) float32 0/1, chosen (rounds, n_sel) int32)."""
    K = num_clients
    n_sel = num_selected(client_fraction, K)
    if n_sel >= K:
        sel = np.ones((rounds, K), np.float32)
        chosen = np.broadcast_to(np.arange(K, dtype=np.int32), (rounds, K))
        return sel, np.ascontiguousarray(chosen)
    rng = np.random.default_rng(seed + 1)
    sel = np.zeros((rounds, K), np.float32)
    chosen = np.zeros((rounds, n_sel), np.int32)
    for t in range(rounds):
        c = rng.choice(K, size=n_sel, replace=False)
        sel[t, c] = 1.0
        chosen[t] = c
    return sel, chosen


# ---------------------------------------------------------------------------
# src/repro_torch/core/chebyshev.py:42-121 -- the attention series, float64
# ---------------------------------------------------------------------------

def _score_fn(x: np.ndarray, slope: float) -> np.ndarray:
    return np.exp(np.where(x >= 0, x, slope * x))


def chebyshev_coeffs(slope: float, degree: int, domain: Tuple[float, float]) -> np.ndarray:
    lo, hi = domain
    n = degree + 1
    k = np.arange(n, dtype=np.float64)
    t = np.cos((2 * k + 1) * np.pi / (2 * n))
    x = 0.5 * (hi - lo) * t + 0.5 * (hi + lo)
    y = np.asarray(_score_fn(x, slope), dtype=np.float64)
    Tkn = np.cos(np.outer(np.arange(n), (2 * k + 1) * np.pi / (2 * n)))
    c = 2.0 / n * (Tkn @ y)
    c[0] *= 0.5
    return c


def attention_power_series(degree: int, domain: Tuple[float, float], slope: float) -> np.ndarray:
    """Monomial coefficients q_n of exp(LeakyReLU(x)) on ``domain``."""
    lo, hi = domain
    if not np.isclose(-lo, hi):
        raise ValueError("power-series path assumes a symmetric domain")
    q_t = np.polynomial.chebyshev.cheb2poly(chebyshev_coeffs(slope, degree, domain))
    return q_t * hi ** -np.arange(len(q_t), dtype=np.float64)


# ---------------------------------------------------------------------------
# src/repro_torch/graphs/graph.py:144-224 -- edge list to CSR, padded lists
# ---------------------------------------------------------------------------

def pad_degree(deg: int, multiple: int = 8) -> int:
    return int(-(-deg // multiple) * multiple)


def edges_to_csr(edges: np.ndarray, num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetrised, self-loops added, duplicates collapsed, rows sorted."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if e.size and (e.min() < 0 or e.max() >= num_nodes):
        raise ValueError("edge endpoints out of range")
    src = np.concatenate([e[:, 0], e[:, 1], np.arange(num_nodes, dtype=np.int64)])
    dst = np.concatenate([e[:, 1], e[:, 0], np.arange(num_nodes, dtype=np.int64)])
    keys = np.sort(src * num_nodes + dst)
    keep = np.empty(keys.shape, dtype=bool)
    keep[:1] = True
    np.not_equal(keys[1:], keys[:-1], out=keep[1:])
    keys = keys[keep]
    rows = keys // num_nodes
    indices = (keys % num_nodes).astype(np.int32)
    indptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=num_nodes), out=indptr[1:])
    return indptr, indices


def csr_to_padded(indptr: np.ndarray, indices: np.ndarray, pad_multiple: int,
                  max_degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each row keeps its first B neighbours (ascending id)."""
    n = indptr.shape[0] - 1
    degs = np.diff(indptr)
    B = pad_degree(max(int(max_degree), 1), pad_multiple)
    take = np.minimum(degs, B)
    col = np.arange(B, dtype=np.int64)[None, :]
    nbr_mask = col < take[:, None]
    pos = indptr[:-1, None] + col
    gathered = indices[np.minimum(pos, indices.size - 1)]
    nbr_idx = np.where(nbr_mask, gathered, 0).astype(np.int32)
    return nbr_idx, nbr_mask


# src/repro_torch/graphs/graph.py:348-377 -- the degree cap: every node keeps
# its self-loop and a uniform subset of at most cap - 1 other neighbours
def capped_neighbor_lists(edges: np.ndarray, num_nodes: int, cap: int, seed: int,
                          pad_multiple: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    indptr, indices = edges_to_csr(edges, num_nodes)
    n = num_nodes
    degs = np.diff(indptr)
    nnz = indices.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), degs)
    rng = np.random.default_rng(seed)
    pri = rng.random(nnz)
    pri[indices == rows] = -1.0
    order = np.lexsort((pri, rows))
    rank_sorted = np.arange(nnz, dtype=np.int64) - np.repeat(indptr[:-1], degs)
    keep = np.zeros(nnz, dtype=bool)
    keep[order] = rank_sorted < cap
    new_indices = indices[keep]
    new_indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows[keep], minlength=n), out=new_indptr[1:])
    return csr_to_padded(new_indptr, new_indices, pad_multiple, cap)
