"""Request scheduler: size/deadline microbatching with latency accounting.

The port of ``repro/serving/scheduler.py``. The timed region of a dispatch
is the whole ``serve_fn`` call; the port's server copies each client's
logits to the host inside it, which waits for the device, so GPU time is
never hidden by asynchronous launches.

The server's unit of efficient work is "one forward per client per batch" —
so queries are buffered and dispatched as microbatches, either when the
buffer reaches ``max_batch_size`` or when the oldest buffered query has
waited ``max_wait`` seconds (the two standard serving knobs).

Batching runs against a *virtual arrival clock* (the workload declares when
each query arrives) while the compute inside each dispatch is timed for
real — the combination models a single-worker queue: a dispatch starts at
``max(trigger time, previous dispatch's completion)`` and completes after
the measured forward time, so queueing delay under load shows up in the
latency distribution exactly as it would in a live service, yet runs are
deterministic and never sleep.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import telemetry
from repro_torch.telemetry.metrics import Histogram


class LatencyStats:
    """Latency/throughput accumulator for served queries.

    Bounded memory under sustained traffic: per-query latencies and batch
    sizes feed fixed-size histograms (geometric buckets, <=1% quantile
    error — see :class:`repro_torch.telemetry.metrics.Histogram`), while
    count and mean stay exact. ``summary()`` has the reference's keys.
    """

    def __init__(self) -> None:
        self.latency = Histogram("latency_s")        # seconds, per query
        self.batch_size = Histogram("batch_size", lo=1.0, hi=1e6)
        self.first_arrival: Optional[float] = None
        self.last_completion: float = 0.0

    def observe_batch(
        self, arrivals: Sequence[float], completion: float
    ) -> None:
        for a in arrivals:
            self.latency.observe(completion - a)
            if self.first_arrival is None or a < self.first_arrival:
                self.first_arrival = a
        self.batch_size.observe(len(arrivals))
        self.last_completion = max(self.last_completion, completion)

    def percentile_ms(self, q: float) -> float:
        if not self.latency.count:
            return 0.0
        return self.latency.quantile(q) * 1e3

    def summary(self) -> Dict[str, float]:
        n = self.latency.count
        span = (
            self.last_completion - self.first_arrival
            if n and self.first_arrival is not None
            else 0.0
        )
        return {
            "queries": float(n),
            "batches": float(self.batch_size.count),
            "mean_batch": float(self.batch_size.mean),
            "p50_ms": self.percentile_ms(50),
            "p99_ms": self.percentile_ms(99),
            "throughput_qps": float(n / span) if span > 0 else 0.0,
            "span_s": float(span),
        }


class MicroBatcher:
    """Buffer queries; dispatch on size or deadline; record latency.

    ``serve_fn(batch) -> results`` is the synchronous backend (one result
    per query, order-preserving). ``timer`` measures real compute time and
    is injectable for deterministic tests.
    """

    def __init__(
        self,
        serve_fn: Callable[[List[Any]], Sequence[Any]],
        *,
        max_batch_size: int = 32,
        max_wait: float = 0.005,
        timer: Callable[[], float] = time.perf_counter,
    ):
        if max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
        if max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.serve_fn = serve_fn
        self.max_batch_size = max_batch_size
        self.max_wait = max_wait
        self.timer = timer
        self.stats = LatencyStats()
        self._buf: List[Tuple[Any, float, int]] = []   # (query, arrival, seq)
        self._now = 0.0                                # worker-busy-until time
        self._results: Dict[int, Any] = {}

    def _dispatch(self, trigger_time: float) -> None:
        if not self._buf:
            return
        batch, self._buf = self._buf, []
        start = max(trigger_time, self._now)
        with telemetry.span("serving.dispatch", batch=len(batch)):
            t0 = self.timer()
            outputs = self.serve_fn([q for q, _, _ in batch])
            compute = self.timer() - t0
        completion = start + compute
        self._now = completion
        if len(outputs) != len(batch):
            raise RuntimeError(
                f"serve_fn returned {len(outputs)} results for a batch of {len(batch)}"
            )
        for (_, _, seq), out in zip(batch, outputs):
            self._results[seq] = out
        self.stats.observe_batch([a for _, a, _ in batch], completion)
        telemetry.counter("serving.dispatches").inc()
        telemetry.histogram("serving.dispatch_compute_s").observe(compute)

    def run(
        self,
        queries: Sequence[Any],
        arrivals: Optional[Sequence[float]] = None,
    ) -> List[Any]:
        """Feed a (time-ordered) workload through the batcher; returns the
        per-query results in input order. ``arrivals`` defaults to
        everything-at-t=0 (pure batch-size batching)."""
        if arrivals is None:
            arrivals = [0.0] * len(queries)
        if len(arrivals) != len(queries):
            raise ValueError("queries and arrivals must have equal length")
        if any(b < a for a, b in zip(arrivals, arrivals[1:])):
            raise ValueError("arrivals must be non-decreasing")
        self._results = {}
        for seq, (q, t) in enumerate(zip(queries, arrivals)):
            # Deadline: the oldest buffered query must not wait past max_wait.
            if self._buf and t - self._buf[0][1] >= self.max_wait:
                self._dispatch(self._buf[0][1] + self.max_wait)
            self._buf.append((q, float(t), seq))
            if len(self._buf) >= self.max_batch_size:
                self._dispatch(t)
        if self._buf:
            # Stream over: the final partial batch waits out its deadline.
            self._dispatch(self._buf[0][1] + self.max_wait)
        return [self._results[i] for i in range(len(queries))]
