"""Process-wide metrics registry: counters, gauges, bounded histograms.

The port's copy of ``repro/telemetry/metrics.py``, pure Python (no torch,
no numpy), so the graph container can count its dense views here. One
:class:`MetricsRegistry` per process (:func:`registry`) holds every named
metric; :func:`counter`, :func:`gauge`, :func:`histogram` and
:func:`snapshot` are thin views over it. Asking for a registered name
under another kind raises. ``telemetry.write_run`` stores the snapshot as
``metrics.json``.
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "registry",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
]


class Counter:
    """Monotone event counter."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value = 0

    @property
    def value(self) -> int:
        return self._value

    def inc(self, n: int = 1) -> None:
        self._value += n

    def reset(self) -> None:
        self._value = 0

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-value measurement (``None`` until first set)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[float] = None

    @property
    def value(self) -> Optional[float]:
        return self._value

    def set(self, v: float) -> None:
        self._value = float(v)

    def reset(self) -> None:
        self._value = None

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Bounded-memory distribution sketch with <=1% quantile error.

    Values are binned into geometric buckets ``[lo * g^i, lo * g^(i+1))``
    with growth ``g``; a bucket's representative value is its geometric
    midpoint, within ``sqrt(g) - 1`` relative error of any value in the
    bucket (0.75% at the default g = 1.015). Quantiles interpolate linearly
    between representatives, as ``np.percentile`` does between order
    statistics. Count, sum (hence mean), min and max are exact. Values
    below ``lo`` land in an underflow bucket represented by the exact
    minimum, values above ``hi`` in an overflow bucket represented by the
    exact maximum.
    """

    __slots__ = (
        "name", "_log_lo", "_log_growth", "_nb", "_counts",
        "count", "total", "vmin", "vmax",
    )

    def __init__(self, name: str = "", lo: float = 1e-9, hi: float = 1e9,
                 growth: float = 1.015):
        if not (0 < lo < hi) or growth <= 1.0:
            raise ValueError(
                f"need 0 < lo < hi and growth > 1, got lo={lo} hi={hi} "
                f"growth={growth}"
            )
        self.name = name
        self._log_lo = math.log(lo)
        self._log_growth = math.log(growth)
        self._nb = int(math.ceil((math.log(hi) - self._log_lo) / self._log_growth))
        # index 0 = underflow, 1.._nb = tracked range, _nb+1 = overflow
        self._counts = [0] * (self._nb + 2)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= 0:
            i = 0
        else:
            i = int((math.log(v) - self._log_lo) / self._log_growth) + 1
            i = 0 if i < 0 else (self._nb + 1 if i > self._nb else i)
        self._counts[i] += 1

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def _rep(self, bucket: int) -> float:
        """A bucket's representative value (clamped to observed range)."""
        if bucket == 0:
            return self.vmin
        if bucket == self._nb + 1:
            return self.vmax
        log_mid = self._log_lo + (bucket - 0.5) * self._log_growth
        return min(max(math.exp(log_mid), self.vmin), self.vmax)

    def quantile(self, q: float) -> float:
        """The q-th percentile (q in [0, 100]), np.percentile-style linear
        interpolation over bucket representatives."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        if self.count == 0:
            return 0.0
        if q == 0.0:
            return self.vmin
        if q == 100.0:
            return self.vmax
        rank = q / 100.0 * (self.count - 1)
        lo_rank = int(math.floor(rank))
        frac = rank - lo_rank

        def value_at(r: int) -> float:
            cum = 0
            for b, c in enumerate(self._counts):
                cum += c
                if cum > r:
                    return self._rep(b)
            return self.vmax

        v_lo = value_at(lo_rank)
        if frac == 0.0:
            return v_lo
        return v_lo + frac * (value_at(lo_rank + 1) - v_lo)

    def reset(self) -> None:
        self._counts = [0] * (self._nb + 2)
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def snapshot(self) -> Dict[str, Any]:
        if self.count == 0:
            return {"type": "histogram", "count": 0}
        return {
            "type": "histogram",
            "count": self.count,
            "mean": self.mean,
            "min": self.vmin,
            "max": self.vmax,
            "p50": self.quantile(50),
            "p90": self.quantile(90),
            "p99": self.quantile(99),
        }


class MetricsRegistry:
    """Named metrics, one instance per process (see :func:`registry`).

    Lookups are get-or-create; asking for an existing name with a
    different metric kind is a bug and raises.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = kind(name, **kwargs)
                    self._metrics[name] = m
        if not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"not a {kind.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kwargs) -> Histogram:
        return self._get(name, Histogram, **kwargs)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Serializable {name: {type, value/stats}} of every metric, by name."""
        return {
            name: m.snapshot() for name, m in sorted(self._metrics.items())
        }

    def reset(self) -> None:
        """Zero every metric (keeps registrations)."""
        for m in self._metrics.values():
            m.reset()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY


def counter(name: str) -> Counter:
    """The process-wide counter ``name`` (created on first use)."""
    return _REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    """The process-wide gauge ``name`` (created on first use)."""
    return _REGISTRY.gauge(name)


def histogram(name: str, **kwargs) -> Histogram:
    """The process-wide histogram ``name`` (created on first use with
    ``kwargs``: ``lo``, ``hi``, ``growth``)."""
    return _REGISTRY.histogram(name, **kwargs)


def snapshot() -> Dict[str, Dict[str, Any]]:
    return _REGISTRY.snapshot()
