"""Span tracer: nested wall/CPU-timed sections with Chrome-trace export.

``Tracer.span("round", round=t)`` is a context manager; spans nest through
a thread-local stack, each finished span recording wall time
(``perf_counter_ns``), process CPU time (``process_time_ns``), its parent
span's name and its nesting depth. The buffer is bounded
(``max_spans``, drops counted) so a long-running service cannot grow it
without limit.

Export targets the Chrome trace-event JSON format (the ``"ph": "X"``
complete-event flavour), which both ``chrome://tracing`` and Perfetto
load directly: one event per span with microsecond ``ts``/``dur``,
pid/tid, and the span's attributes under ``args``.

The tracer itself is always constructible and cheap; the *decision* to
trace lives in :mod:`repro_torch.telemetry` — when telemetry is disabled,
``repro_torch.telemetry.span()`` hands out a shared no-op context manager and
this module is never consulted on the hot path.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

__all__ = ["NULL_SPAN", "SpanRecord", "Tracer"]


class _NullSpan:
    """Reusable, re-entrant no-op context manager (the disabled path)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class SpanRecord(NamedTuple):
    name: str
    start_ns: int          # perf_counter_ns at entry
    dur_ns: int            # wall duration
    cpu_ns: int            # process CPU time consumed inside the span
    tid: int
    parent: Optional[str]  # enclosing span's name (None at top level)
    depth: int             # 0 = top level
    args: Dict[str, Any]


class _Span:
    __slots__ = ("_tracer", "name", "args", "_start", "_cpu0", "_parent", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        stack = self._tracer._stack()
        self._parent = stack[-1][0] if stack else None
        self._depth = len(stack)
        stack.append((self.name, self))
        self._cpu0 = time.process_time_ns()
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter_ns()
        cpu = time.process_time_ns() - self._cpu0
        stack = self._tracer._stack()
        if stack and stack[-1][1] is self:
            stack.pop()
        self._tracer._record(SpanRecord(
            name=self.name, start_ns=self._start, dur_ns=end - self._start,
            cpu_ns=cpu, tid=threading.get_ident(), parent=self._parent,
            depth=self._depth, args=self.args,
        ))
        return False

    def set(self, **kwargs) -> None:
        """Attach attributes to the span after entry (e.g. a result)."""
        self.args.update(kwargs)


class Tracer:
    """Collects finished :class:`SpanRecord`s, bounded at ``max_spans``."""

    def __init__(self, max_spans: int = 200_000):
        self.max_spans = int(max_spans)
        self.records: List[SpanRecord] = []
        self.dropped = 0
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        if len(self.records) >= self.max_spans:
            self.dropped += 1
            return
        self.records.append(rec)

    def span(self, name: str, /, **args) -> _Span:
        return _Span(self, name, args)

    def reset(self) -> None:
        self.records = []
        self.dropped = 0
        self._local = threading.local()

    # -- export -------------------------------------------------------------

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (loadable in chrome://tracing/Perfetto).

        ``ts`` is each span's start offset from the earliest recorded span
        in microseconds (Chrome wants a common, smallish time base);
        ``dur`` is the wall duration; CPU time, parent and depth ride in
        ``args`` alongside the caller's attributes.
        """
        pid = os.getpid()
        base = min((r.start_ns for r in self.records), default=0)
        events = []
        for r in self.records:
            args = {"cpu_ms": r.cpu_ns / 1e6, "depth": r.depth}
            if r.parent is not None:
                args["parent"] = r.parent
            args.update(r.args)
            events.append({
                "name": r.name,
                "cat": "repro_torch",
                "ph": "X",
                "ts": (r.start_ns - base) / 1e3,
                "dur": r.dur_ns / 1e3,
                "pid": pid,
                "tid": r.tid,
                "args": args,
            })
        meta: Dict[str, Any] = {"dropped_spans": self.dropped}
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": meta}
