"""Secure aggregation: a real multi-party masking protocol + pairwise masks.

The port of ``repro/privacy/secure_agg.py``. Two implementations, selected
by ``PrivacyConfig.secure_agg_mode``:

``"protocol"`` (default) — a single-server simulation of the Bonawitz et
al. (2017) protocol, run host-side by the cohort driver
(federated/cohort.py): per-round Diffie-Hellman key agreement over the
RFC 3526 group 14, fixed-point quantization of each client's
(staleness-scaled) update delta into Z_p with p = 2^61 - 1, antisymmetric
pairwise field masks that cancel exactly in the survivors' sum, and
Shamir recovery of dropped clients' masks (privacy/shamir.py). This half
is host numpy and hashlib, copied from the reference: given the same
float64 vectors its payloads and ``finalize`` output equal the
reference's bit for bit.

``"pairwise"`` — antisymmetric float masks from a PRF, added to each
selected client's params and cancelling in the FedAvg sum
(:func:`pair_key`, :func:`client_mask`, :func:`add_client_mask`). The
reference draws them with ``jax.random``; torch cannot reproduce those
bits, so here each pair's mask comes from a CPU ``torch.Generator`` seeded
through :func:`repro_torch._rng.fold_in`. The masks keep the reference's
properties: they cancel over the selected set, an unselected client's mask
is zero, and they are deterministic and depend on the round.

Quantization error: one round trip costs at most ``quant_range /
(2^quant_bits - 1)`` per element per client (defaults: 32 / (2^32 - 1)
≈ 7.5e-9), and the decoded *mean* error is bounded by that same step.
Elements outside ``[-quant_range, quant_range]`` saturate; the round
reports a saturation count that the driver surfaces as a telemetry
counter.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch._rng import fold_in, generator
from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.privacy.shamir import reconstruct_secret, share_secret

Tree = Any

# ---------------------------------------------------------------------------
# Protocol constants
# ---------------------------------------------------------------------------

# Masking field: the Mersenne prime 2^61 - 1. Fits np.uint64 with headroom —
# a + b for a, b < p stays below 2^62, so pairwise modular addition never
# overflows — and admits ~2^29 clients at 32-bit quantization before the
# aggregate could wrap.
FIELD_PRIME = np.uint64((1 << 61) - 1)

# RFC 3526 group 14: 2048-bit MODP prime, generator 2. Plenty for a
# simulation and cheap enough (~4 ms/modexp) that the n_adv <= 64 configs
# used in tests and CI finish key agreement in well under a second.
DH_GENERATOR = 2
DH_PRIME = int(
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF",
    16,
)

_EXPONENT_BITS = 256  # DH exponent size; 2x the ~112-bit strength of group 14


class DropoutRecoveryError(RuntimeError):
    """Too few surviving shareholders to reconstruct a dropped client's
    exponent — the caller must fall back to the degraded path."""


# ---------------------------------------------------------------------------
# Deterministic key material
# ---------------------------------------------------------------------------


def _sha_int(*parts: bytes) -> int:
    """512 deterministic bits from SHA-256 in counter mode."""
    h0 = hashlib.sha256(b"\x00".join(parts) + b"|0").digest()
    h1 = hashlib.sha256(b"\x00".join(parts) + b"|1").digest()
    return int.from_bytes(h0 + h1, "big")


def dh_secret(run_seed: int, round_idx: int, attempt: int, client_id: int) -> int:
    """Client's per-round DH exponent, derived from the run seed.

    Deterministic so that the vmap and shard_map backends (and a resumed
    run) replay the identical protocol; ``attempt`` separates the degraded
    re-run from the original execution.
    """
    raw = _sha_int(
        b"fedgat-dh-secret",
        int(run_seed).to_bytes(8, "big", signed=True),
        int(round_idx).to_bytes(8, "big"),
        int(attempt).to_bytes(4, "big"),
        int(client_id).to_bytes(8, "big"),
    )
    # Clamp into [2, 2^256): exponent 0/1 would leak the generator.
    return (raw % ((1 << _EXPONENT_BITS) - 2)) + 2


def dh_public(secret: int) -> int:
    """g^secret mod p — the broadcast half of the key agreement."""
    return pow(DH_GENERATOR, secret, DH_PRIME)


def dh_shared(secret: int, peer_public: int) -> int:
    """peer_public^secret mod p == g^(a_i a_j): same value on both ends."""
    if not 1 < peer_public < DH_PRIME - 1:
        raise ValueError("peer public key outside the valid subgroup range")
    return pow(peer_public, secret, DH_PRIME)


def pair_seed(shared: int, i: int, j: int, round_idx: int, attempt: int) -> int:
    """Hash a DH shared secret into the pair's mask-PRG seed (order-free)."""
    lo, hi = (i, j) if i < j else (j, i)
    return _sha_int(
        b"fedgat-pair-seed",
        shared.to_bytes((DH_PRIME.bit_length() + 7) // 8, "big"),
        int(lo).to_bytes(8, "big"),
        int(hi).to_bytes(8, "big"),
        int(round_idx).to_bytes(8, "big"),
        int(attempt).to_bytes(4, "big"),
    )


def mask_vector(seed: int, dim: int) -> np.ndarray:
    """Pseudorandom field vector in [0, FIELD_PRIME)^dim from a pair seed.

    numpy's Philox-free default (PCG64 via SeedSequence) is stable across
    platforms and numpy versions, which the cross-backend parity tests
    rely on.
    """
    rng = np.random.default_rng(seed)
    return rng.integers(0, int(FIELD_PRIME), size=dim, dtype=np.uint64)


# ---------------------------------------------------------------------------
# Fixed-point quantization into the field
# ---------------------------------------------------------------------------


def quantize(
    vec: np.ndarray, bits: int, clip_range: float
) -> Tuple[np.ndarray, int]:
    """Map floats in [-clip_range, clip_range] to integers in [0, 2^bits).

    Returns ``(field_vec, n_saturated)``; out-of-range elements clamp to
    the nearest representable value (counted, surfaced via telemetry).
    """
    levels = float((1 << bits) - 1)
    scale = levels / (2.0 * clip_range)
    x = np.asarray(vec, dtype=np.float64)
    n_saturated = int(np.count_nonzero(np.abs(x) > clip_range))
    q = np.rint((np.clip(x, -clip_range, clip_range) + clip_range) * scale)
    return q.astype(np.uint64), n_saturated


def dequantize_sum(
    field_sum: np.ndarray, n_clients: int, bits: int, clip_range: float
) -> np.ndarray:
    """Invert :func:`quantize` on a *sum* of ``n_clients`` quantized vectors."""
    levels = float((1 << bits) - 1)
    scale = levels / (2.0 * clip_range)
    return field_sum.astype(np.float64) / scale - n_clients * clip_range


def quantization_step(bits: int, clip_range: float) -> float:
    """Worst-case per-element round-trip error of one quantized update."""
    return clip_range / float((1 << bits) - 1)


# ---------------------------------------------------------------------------
# The per-round protocol object
# ---------------------------------------------------------------------------


def default_threshold(n_advertised: int) -> int:
    """Reconstruction threshold: a majority, capped at n-1 shareholders.

    Each client's exponent is shared among the *other* n-1 advertised
    clients, so the threshold cannot exceed n-1; a majority (floor(n/2)+1)
    keeps reconstruction possible after minority dropout while an
    adversary needs to corrupt more than half the cohort to unmask anyone.
    """
    if n_advertised < 2:
        return 1
    return min(n_advertised - 1, n_advertised // 2 + 1)


class SecureAggRound:
    """One round of the masking protocol over a fixed advertised cohort.

    The driver plays both sides: :meth:`client_payload` is the client role
    (quantize, lift, mask), :meth:`accumulate` / :meth:`finalize` the
    server role (field-sum payloads as cohorts stream through, then unmask
    and decode once the survivor set is known). Field addition is
    associative and commutative, so payloads may arrive in any cohort
    order — the decoded aggregate is bit-identical regardless of how the
    round was staged.
    """

    def __init__(
        self,
        run_seed: int,
        round_idx: int,
        advertised: Sequence[int],
        dim: int,
        *,
        quant_bits: int = 32,
        quant_range: float = 32.0,
        threshold: int | None = None,
        attempt: int = 0,
    ):
        self.advertised = sorted(int(c) for c in advertised)
        if len(set(self.advertised)) != len(self.advertised):
            raise ValueError("advertised client ids must be distinct")
        self.round_idx = int(round_idx)
        self.attempt = int(attempt)
        self.dim = int(dim)
        self.quant_bits = int(quant_bits)
        self.quant_range = float(quant_range)
        n = len(self.advertised)
        self.threshold = default_threshold(n) if threshold is None else int(threshold)
        if n >= 2 and not (1 <= self.threshold <= n - 1):
            raise ValueError(
                f"secure_agg_threshold must be in [1, {n - 1}] for "
                f"{n} advertised clients, got {self.threshold}"
            )
        if n * ((1 << self.quant_bits) - 1) >= int(FIELD_PRIME):
            raise ValueError(
                f"{n} clients at {self.quant_bits}-bit quantization can "
                "overflow the masking field; lower quant_bits"
            )

        # --- key agreement (client side, simulated in one process) -------
        self._secrets: Dict[int, int] = {
            c: dh_secret(run_seed, self.round_idx, self.attempt, c)
            for c in self.advertised
        }
        publics = {c: dh_public(s) for c, s in self._secrets.items()}
        # Each client i computes shared secrets with every peer from the
        # *broadcast publics* — pow(publics[j], a_i). Symmetry with the
        # peer's pow(publics[i], a_j) is what makes the seeds agree; the
        # protocol tests assert it explicitly.
        self._seeds: Dict[Tuple[int, int], int] = {}
        for a_pos, i in enumerate(self.advertised):
            for j in self.advertised[a_pos + 1 :]:
                shared = dh_shared(self._secrets[i], publics[j])
                self._seeds[(i, j)] = pair_seed(
                    shared, i, j, self.round_idx, self.attempt
                )

        # --- exponent sharing for dropout recovery ------------------------
        # shares[owner][holder] — holder's share of owner's DH exponent.
        self._shares: Dict[int, Dict[int, int]] = {}
        if n >= 2:
            for c in self.advertised:
                holders = [p for p in self.advertised if p != c]
                tag = (
                    f"r{self.round_idx}|a{self.attempt}|c{c}".encode()
                )
                by_x = share_secret(
                    self._secrets[c],
                    [h + 1 for h in holders],
                    self.threshold,
                    tag,
                )
                self._shares[c] = {h: by_x[h + 1] for h in holders}

        self._mask_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._field_sum = np.zeros(self.dim, dtype=np.uint64)
        self._contributors: List[int] = []
        self.n_saturated = 0

    # -- helpers ------------------------------------------------------------

    def _pair_mask(self, i: int, j: int) -> np.ndarray:
        key = (i, j) if i < j else (j, i)
        m = self._mask_cache.get(key)
        if m is None:
            m = mask_vector(self._seeds[key], self.dim)
            self._mask_cache[key] = m
        return m

    @staticmethod
    def _field_add(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return (a + b) % FIELD_PRIME

    @staticmethod
    def _field_sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return (a + (FIELD_PRIME - b)) % FIELD_PRIME

    # -- client role ----------------------------------------------------------

    def client_payload(self, client_id: int, vec: np.ndarray) -> np.ndarray:
        """Quantize ``vec`` and add this client's pairwise masks.

        Sign convention matches the pairwise mode: +m towards
        higher-numbered peers, -m towards lower ones, so the masks
        telescope to zero over any full survivor set.
        """
        c = int(client_id)
        if c not in self._secrets:
            raise ValueError(f"client {c} was not advertised this round")
        q, sat = quantize(vec, self.quant_bits, self.quant_range)
        self.n_saturated += sat
        payload = q % FIELD_PRIME
        for p in self.advertised:
            if p == c:
                continue
            m = self._pair_mask(c, p)
            if c < p:
                payload = self._field_add(payload, m)
            else:
                payload = self._field_sub(payload, m)
        return payload

    # -- server role ----------------------------------------------------------

    def accumulate(self, client_id: int, payload: np.ndarray) -> None:
        """Fold one masked payload into the running field sum."""
        c = int(client_id)
        if c in self._contributors:
            raise ValueError(f"client {c} already contributed this round")
        self._contributors.append(c)
        self._field_sum = self._field_add(self._field_sum, payload)

    def recover_dropped_secret(self, dropped_id: int, survivors: Sequence[int]) -> int:
        """Reconstruct a dropped client's exponent from survivor shares."""
        held = {
            s + 1: self._shares[dropped_id][s]
            for s in survivors
            if s in self._shares.get(dropped_id, {})
        }
        if len(held) < self.threshold:
            raise DropoutRecoveryError(
                f"client {dropped_id}: {len(held)} shares from survivors, "
                f"need {self.threshold}"
            )
        return reconstruct_secret(held, self.threshold)

    def finalize(self, survivors: Sequence[int]) -> Tuple[np.ndarray, Dict[str, int]]:
        """Unmask the survivor sum and decode it back to floats.

        ``survivors`` must equal the set of accumulated contributors.
        Masks between pairs of survivors already cancelled in the field
        sum; for each dropped client d we reconstruct its exponent from
        survivor shares, regenerate the seeds m_{s,d} and subtract the
        orphaned ``sign(s, d) * m_{s,d}`` each survivor s had added.

        Returns ``(float_sum, info)`` where ``float_sum`` is the decoded
        sum of the survivors' input vectors and ``info`` counts recovered
        seeds and saturated elements.
        """
        surv = sorted(int(s) for s in survivors)
        if surv != sorted(self._contributors):
            raise ValueError(
                f"survivors {surv} != accumulated contributors "
                f"{sorted(self._contributors)}"
            )
        dropped = [c for c in self.advertised if c not in set(surv)]
        total = self._field_sum
        recovered = 0
        public = {s: dh_public(self._secrets[s]) for s in surv} if dropped else {}
        for d in dropped:
            secret_d = self.recover_dropped_secret(d, surv)
            for s in surv:
                shared = dh_shared(secret_d, public[s])
                seed = pair_seed(shared, d, s, self.round_idx, self.attempt)
                m = mask_vector(seed, self.dim)
                # survivor s added sign(s, d) * m_{s,d}; undo it.
                if s < d:
                    total = self._field_sub(total, m)
                else:
                    total = self._field_add(total, m)
            recovered += 1
        float_sum = dequantize_sum(
            total, len(surv), self.quant_bits, self.quant_range
        )
        return float_sum, {
            "recovered_seeds": recovered,
            "dropped": len(dropped),
            "saturated": self.n_saturated,
        }


# ---------------------------------------------------------------------------
# Flattening between parameter trees and protocol vectors
# ---------------------------------------------------------------------------


def flatten_pytree(tree: Tree) -> Tuple[np.ndarray, Callable[[np.ndarray], Tree]]:
    """Concatenate a tree of tensors (or arrays) into one float64 host
    vector, in :func:`repro_torch._tree.tree_leaves` order.

    Returns the vector and an ``unflatten`` closure giving back a tree of
    tensors with the original structure, shapes, dtypes and devices.
    """
    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(tree)]
    host = [leaf.detach().cpu().numpy() for leaf in leaves]
    vec = (
        np.concatenate([h.astype(np.float64).ravel() for h in host])
        if host
        else np.zeros(0, dtype=np.float64)
    )

    def unflatten(v: np.ndarray) -> Tree:
        out = []
        offset = 0
        for leaf, h in zip(leaves, host):
            part = v[offset : offset + h.size].reshape(h.shape).astype(h.dtype)
            out.append(torch.from_numpy(part).to(leaf.device))
            offset += h.size
        return tree_unflatten(tree, out)

    return vec, unflatten


# ---------------------------------------------------------------------------
# "pairwise" mode: antisymmetric PRF masks
# ---------------------------------------------------------------------------


def pair_key(base: int, round_idx: int, i: int, j: int) -> int:
    """Shared PRF seed of the unordered client pair {i, j} at a round."""
    lo, hi = (i, j) if i < j else (j, i)
    return fold_in(fold_in(fold_in(base, round_idx), lo), hi)


@torch.no_grad()
def client_mask(
    base: int,
    round_idx: int,
    client_id: int,
    sel_row: np.ndarray,
    template: Tree,
    scale: float,
) -> Tree:
    """Client ``client_id``'s total mask Σ_{j≠k} ±sel_k·sel_j·m_{kj}.

    sel_row: (K,) 0/1 participation weights of this round. The sign is
    +1 towards higher-numbered peers, -1 towards lower ones, so summing
    the masks over the selected clients telescopes to zero. Leaf ``i`` of
    ``m_{kj}`` is drawn in float32 from a CPU generator seeded
    ``fold_in(pair_key, i)``; the mask is summed on the CPU in peer order
    and moved to each leaf's device.
    """
    c = int(client_id)
    sel = np.asarray(sel_row, np.float32)
    leaves = tree_leaves(template)
    acc = [torch.zeros(x.shape, dtype=x.dtype) for x in leaves]
    if sel[c] != 0:
        for j in np.nonzero(sel)[0].tolist():
            if j == c:
                continue
            w = float(np.float32(scale) * np.float32(1.0 if c < j else -1.0)
                      * sel[j] * sel[c])
            pk = pair_key(base, round_idx, c, j)
            for i, x in enumerate(leaves):
                acc[i] += w * torch.randn(x.shape, generator=generator(fold_in(pk, i)),
                                          dtype=x.dtype)
    return tree_unflatten(template, [a.to(x.device) for a, x in zip(acc, leaves)])


@torch.no_grad()
def add_client_mask(
    base: int,
    round_idx: int,
    client_id: int,
    sel_row: np.ndarray,
    params: Tree,
    scale: float,
) -> Tree:
    """params + this client's pairwise mask (the shipped, masked update)."""
    mask = client_mask(base, round_idx, client_id, sel_row, params, scale)
    return tree_map(torch.add, params, mask)
