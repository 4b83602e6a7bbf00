"""RDP (moments) accountant for the per-round sampled Gaussian mechanism.

A copy of ``repro/privacy/accountant.py`` (pure ``math``): every value
equals the reference's.

The federated Trainer's per-round mechanism, at client level, is:

  * sample ``n_sel`` of ``K`` clients (Algorithm 2's CS(t), sampling rate
    ``q = n_sel / K``),
  * each participating client contributes a delta clipped to L2 norm C,
  * the released sum carries Gaussian noise of std ``σ · C`` (each client
    adds its 1/sqrt(n_sel) share locally — see privacy/dp.py).

That is the Sampled Gaussian Mechanism with noise multiplier σ; its Rényi
DP at integer order α is (Mironov, Talwar & Zhang 2019, Eq. 3 — the
``log A`` formula tensorflow-privacy calls ``_compute_log_a_int``):

  RDP(α) = 1/(α-1) · log Σ_{k=0..α} C(α,k) (1-q)^{α-k} q^k e^{(k²-k)/2σ²}

with the special case RDP(α) = α / (2σ²) at q = 1 (plain Gaussian).
Rounds compose additively in RDP; the (ε, δ) conversion is the improved
bound of Canonne, Kamath & Steinke 2020:

  ε = min_α  T·RDP(α) + log((α-1)/α) - (log δ + log α)/(α-1)

Pure Python on purpose — the accountant runs host-side once per
result, never on the device. Caveats (recorded in the README): accounting is
at CLIENT level (one client's entire update is the unit of privacy), CS(t)
is sampling WITHOUT replacement over a fixed population while the SGM
bound assumes Poisson sampling — the standard, slightly optimistic
approximation every DP-FL paper makes at these q — and the pack mechanism
(privacy/pack_dp.py) is accounted separately as a single-shot release.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence

DEFAULT_ORDERS: Sequence[int] = tuple(range(2, 64)) + (72, 96, 128, 192, 256, 512)


def _log_comb(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _logsumexp(xs: Iterable[float]) -> float:
    xs = list(xs)
    m = max(xs)
    if m == -math.inf:
        return -math.inf
    return m + math.log(sum(math.exp(x - m) for x in xs))


def rdp_sampled_gaussian(q: float, noise_multiplier: float, order: int) -> float:
    """RDP of one SGM step at integer ``order`` >= 2."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"sampling rate must be in [0, 1], got {q}")
    if order < 2 or int(order) != order:
        raise ValueError(f"integer order >= 2 required, got {order}")
    if noise_multiplier <= 0:
        return math.inf
    if q == 0.0:
        return 0.0
    sigma2 = noise_multiplier**2
    if q == 1.0:
        return order / (2.0 * sigma2)
    terms = [
        _log_comb(order, k)
        + k * math.log(q)
        + (order - k) * math.log1p(-q)
        + (k * k - k) / (2.0 * sigma2)
        for k in range(order + 1)
    ]
    return _logsumexp(terms) / (order - 1)


def rdp_to_epsilon(rdp: Sequence[float], orders: Sequence[int], delta: float) -> float:
    """Best (ε, δ) across orders via the CKS 2020 conversion (clamped >= 0)."""
    if not (0.0 < delta < 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    best = math.inf
    for r, a in zip(rdp, orders):
        if math.isinf(r):
            continue
        eps = r + math.log((a - 1) / a) - (math.log(delta) + math.log(a)) / (a - 1)
        best = min(best, eps)
    return max(best, 0.0)


class RdpAccountant:
    """Composes SGM rounds in RDP; ``get_epsilon`` converts at a δ.

    >>> acct = RdpAccountant()
    >>> acct.step(noise_multiplier=1.0, sampling_rate=0.5, steps=60)
    >>> eps = acct.get_epsilon(delta=1e-5)
    """

    def __init__(self, orders: Optional[Sequence[int]] = None):
        self.orders = tuple(orders) if orders is not None else tuple(DEFAULT_ORDERS)
        self._rdp = [0.0] * len(self.orders)

    def step(self, noise_multiplier: float, sampling_rate: float, steps: int = 1) -> None:
        if steps < 0:
            raise ValueError(f"steps must be >= 0, got {steps}")
        if steps == 0:
            return
        for i, a in enumerate(self.orders):
            self._rdp[i] += steps * rdp_sampled_gaussian(
                sampling_rate, noise_multiplier, a
            )

    def get_epsilon(self, delta: float) -> float:
        if all(r == 0.0 for r in self._rdp):
            return 0.0
        return rdp_to_epsilon(self._rdp, self.orders, delta)


def sensitivity_factor(granularity: str) -> float:
    """L2-sensitivity multiplier of the chosen unit of protection.

    "client": add/remove one client's entire shard — removing a client
    removes one vector of norm <= C from the noised sum, sensitivity C,
    factor 1 (the calibration the Gaussian mechanism assumes).

    "node": substitute one graph node inside a client's shard — the
    client's delta moves within the C-ball, so the released sum changes
    by at most ||δ - δ'|| <= 2C, factor 2. Noise calibrated to C therefore
    buys node-level protection at an *effective* multiplier σ/2; at fixed
    σ, ε_node >= ε_client (the ordering the edge-case tests pin down).
    Node-level accounting is only sound because degree-capped sampling
    (graphs.sample_neighbors) bounds one node's influence on every other
    client artifact — see pack_dp.node_influence_bound for the pack leg.
    """
    if granularity == "client":
        return 1.0
    if granularity == "node":
        return 2.0
    raise ValueError(f"unknown dp_granularity {granularity!r}")


def compute_epsilon(
    noise_multiplier: float,
    steps: int,
    sampling_rate: float,
    delta: float,
    orders: Optional[Sequence[int]] = None,
    sensitivity: float = 1.0,
) -> float:
    """ε of ``steps`` SGM rounds (∞ when noise is off, 0 when steps == 0).

    ``sensitivity`` rescales the unit of protection: noise calibrated to
    sensitivity C protects a quantity of sensitivity ``sensitivity * C``
    at effective multiplier ``noise_multiplier / sensitivity`` (e.g. 2.0
    for node-level substitution — see :func:`sensitivity_factor`).
    """
    if steps == 0:
        return 0.0
    if sensitivity <= 0:
        raise ValueError(f"sensitivity must be > 0, got {sensitivity}")
    if noise_multiplier <= 0:
        return math.inf
    acct = RdpAccountant(orders)
    acct.step(noise_multiplier / sensitivity, sampling_rate, steps)
    return acct.get_epsilon(delta)
