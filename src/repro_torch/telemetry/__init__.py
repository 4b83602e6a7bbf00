"""repro_torch.telemetry — spans and process-wide metrics for the port.

The port's copy of ``repro.telemetry``: a :func:`span` context manager
and an :func:`event` recorder that are off by default (no-ops until
:func:`enable`), and the counters, gauges and histograms of
:mod:`repro_torch.telemetry.metrics`, which are always live. No
manifests, JSONL sink or exporters.
"""
from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, List, NamedTuple

from repro_torch.telemetry import metrics as metrics
from repro_torch.telemetry.metrics import counter, gauge, histogram

__all__ = [
    "SpanRecord", "counter", "disable", "enable", "enabled", "event", "events",
    "gauge", "histogram", "metrics", "records", "reset", "span",
]

_NULL_SPAN = nullcontext()
_enabled = False
_records: List["SpanRecord"] = []
_events: List[Dict[str, Any]] = []
_local = threading.local()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int          # perf_counter_ns at entry
    dur_ns: int            # wall duration
    depth: int             # 0 = top level
    args: Dict[str, Any]


class _Span:
    __slots__ = ("name", "args", "_start", "_depth")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._depth = getattr(_local, "depth", 0)
        _local.depth = self._depth + 1
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        _local.depth = self._depth
        _records.append(
            SpanRecord(self.name, self._start, end - self._start, self._depth, self.args)
        )
        return False


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn span recording on (metrics are always live)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop the recorded spans and events."""
    _records.clear()
    _events.clear()


def events() -> List[Dict[str, Any]]:
    """The events recorded since the last :func:`reset`, in order."""
    return list(_events)


def records() -> List[SpanRecord]:
    """The spans recorded since the last :func:`reset`, in finish order."""
    return list(_records)


def span(name: str, /, **args):
    """A timed span when telemetry is enabled; a shared no-op context
    manager when disabled (the default)."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, args)


def event(name: str, /, **fields) -> None:
    """Record a structured event ``{"event": name, "ts": ..., **fields}``
    when telemetry is enabled; a no-op when disabled (the default)."""
    if _enabled:
        _events.append({"event": name, "ts": time.time(), **fields})
