"""Shamir t-of-n secret sharing over the Mersenne prime 2^521 - 1.

A copy of ``repro/privacy/shamir.py``, bit for bit.

The secure-aggregation protocol (privacy/secure_agg.py) shares each
client's per-round Diffie-Hellman exponent among the other advertised
clients so the server can reconstruct a *dropped* client's pairwise mask
seeds from any ``threshold`` surviving shareholders (Bonawitz et al. 2017,
the seed-reconstruction phase). The share field must therefore exceed the
secret range: DH exponents are 256-bit, and 2^521 - 1 is the next Mersenne
prime with comfortable headroom, so secrets embed without chunking.

Pure Python integers on purpose — this runs host-side, once per round,
over at most a few hundred shares; no torch, no numpy.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

# 2^521 - 1 (the 13th Mersenne prime). Every secret shared here must be
# strictly below it; DH exponents (< 2^256) always are.
SHARE_PRIME = (1 << 521) - 1


def _poly_coeffs(secret: int, threshold: int, tag: bytes) -> List[int]:
    """Degree-(threshold-1) polynomial with a(0) = secret.

    Coefficients are derived deterministically from (secret, tag) via
    SHA-256 counter mode, so the whole protocol stays replayable from the
    run seed — the property every backend-parity test in this repo leans
    on. A real deployment would draw them from an entropy source instead.
    """
    if not 0 <= secret < SHARE_PRIME:
        raise ValueError("secret out of field range")
    coeffs = [secret]
    for i in range(1, threshold):
        h = hashlib.sha256(
            b"shamir-coeff|" + tag + b"|" + i.to_bytes(4, "big")
            + secret.to_bytes(66, "big")
        ).digest()
        # 512 bits of hash output, reduced mod p (bias < 2^-9, irrelevant
        # for mask seeds; the coefficients only need to be unpredictable).
        h2 = hashlib.sha256(h).digest()
        coeffs.append(int.from_bytes(h + h2, "big") % SHARE_PRIME)
    return coeffs


def _eval_poly(coeffs: Sequence[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % SHARE_PRIME
    return acc


def share_secret(
    secret: int, xs: Sequence[int], threshold: int, tag: bytes = b""
) -> Dict[int, int]:
    """Split ``secret`` into one share per evaluation point in ``xs``.

    ``xs`` are the shareholders' (nonzero, distinct) field points —
    the protocol uses ``client_id + 1``. Any ``threshold`` of the returned
    shares reconstruct the secret; fewer reveal nothing (information-
    theoretically, given random coefficients).
    """
    if threshold < 1:
        raise ValueError(f"threshold must be >= 1, got {threshold}")
    if len(set(xs)) != len(xs) or any(x == 0 for x in xs):
        raise ValueError("share points must be distinct and nonzero")
    if threshold > len(xs):
        raise ValueError(
            f"threshold {threshold} exceeds the {len(xs)} shareholders — "
            "the secret could never be reconstructed"
        )
    coeffs = _poly_coeffs(secret, threshold, tag)
    return {x: _eval_poly(coeffs, x) for x in xs}


def reconstruct_secret(shares: Dict[int, int], threshold: int) -> int:
    """Lagrange interpolation at 0 from ``threshold`` of the shares.

    Raises ``ValueError`` when fewer than ``threshold`` shares are
    available — the caller (the secure-agg server) turns that into its
    degraded-mode path.
    """
    if len(shares) < threshold:
        raise ValueError(
            f"need >= {threshold} shares to reconstruct, have {len(shares)}"
        )
    pts: List[Tuple[int, int]] = sorted(shares.items())[:threshold]
    secret = 0
    for i, (xi, yi) in enumerate(pts):
        num = den = 1
        for j, (xj, _) in enumerate(pts):
            if i == j:
                continue
            num = (num * (-xj)) % SHARE_PRIME
            den = (den * (xi - xj)) % SHARE_PRIME
        secret = (secret + yi * num * pow(den, -1, SHARE_PRIME)) % SHARE_PRIME
    return secret
