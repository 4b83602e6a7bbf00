"""Span tracer: nested wall/CPU-timed sections, device time on request,
and Chrome-trace export.

``Tracer.span("round", round=t)`` is a context manager; spans nest through
a thread-local stack, each finished span recording wall time
(``perf_counter_ns``), process CPU time (``process_time_ns``), its own id,
its parent span's name and id, and its nesting depth. A span opened
inside one that carries a ``call`` attribute inherits it, so every span
of one call carries the call's id. The buffer is
bounded (``max_spans``, drops counted) so a long-running service cannot
grow it without limit.

``Tracer.device_span(...)`` is the same span with device time besides: a
pair of ``torch.cuda.Event(enable_timing=True)`` recorded at entry and exit
on the stream current at entry, when CUDA is already initialized (a span
never initializes it). The events are resolved lazily, by
:meth:`Tracer.resolve` (``telemetry.records()`` and the export call it),
into the record's ``device_ns`` (the stream time between them) and
``device_start_ns`` (when the stream reached the entry event, on the span
clock), and are then reused by later spans.

One clock: spans (and the event sink's ``t_ns``) stamp ``perf_counter_ns``.
The tracer's :class:`Anchor`, taken at construction and at every
:meth:`Tracer.reset` and ``telemetry.enable()``, pairs that clock with the
Unix-epoch clock (``time_ns``, the profiler's) and, once CUDA is up, with
a CUDA event recorded after a synchronize, which places device times on
the span clock.

Export targets the Chrome trace-event JSON format (the ``"ph": "X"``
complete-event flavour), which both ``chrome://tracing`` and Perfetto
load directly: one event per span with microsecond ``ts``/``dur``,
pid/tid, and the span's attributes under ``args``; each span's device
extent as a second event on a track named for the device; the anchor
under ``otherData``.

The tracer itself is always constructible and cheap; the *decision* to
trace lives in :mod:`repro_torch.telemetry` — when telemetry is disabled,
``repro_torch.telemetry.span()`` hands out a shared no-op context manager and
this module is never consulted on the hot path.
"""
from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

__all__ = ["Anchor", "NULL_SPAN", "SpanRecord", "Tracer"]

DEVICE_TID = -1      # the device track's tid in the Chrome export (less the device index)


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
    span_id: int = 0                        # unique within the tracer
    parent_id: Optional[int] = None         # the enclosing span's span_id
    device_ns: Optional[int] = None         # stream time between the span's events
    device_start_ns: Optional[int] = None   # the entry event on the span clock


class Anchor(NamedTuple):
    """One instant on the span clock, the Unix-epoch clock and (when CUDA
    was up) the device's stream."""

    perf_ns: int
    unix_ns: int
    event: Any = None                 # torch.cuda.Event recorded at perf_ns
    device: Optional[int] = None      # the CUDA device it was recorded on


def _cuda():
    """``torch`` when CUDA is already initialized in this process, else
    ``None``; never imports torch or initializes CUDA."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch


class _Span:
    __slots__ = ("_tracer", "name", "args", "_device", "_start", "_cpu0", "_parent",
                 "_depth", "_id", "_events")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any],
                 device: bool = False):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._device = device

    def __enter__(self) -> "_Span":
        tracer = self._tracer
        stack = tracer._stack()
        parent = self._parent = stack[-1] if stack else None
        if parent is not None and "call" in parent.args:
            self.args.setdefault("call", parent.args["call"])
        self._depth = len(stack)
        self._id = next(tracer._ids)
        stack.append(self)
        self._cpu0 = time.process_time_ns()
        self._start = time.perf_counter_ns()
        self._events = tracer._device_events() if self._device else None
        return self

    def __exit__(self, *exc) -> bool:
        events = self._events
        if events is not None:
            events[1].record(events[2])         # on the stream the entry was recorded on
        end = time.perf_counter_ns()
        cpu = time.process_time_ns() - self._cpu0
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        parent = self._parent
        self._tracer._record(SpanRecord(
            name=self.name, start_ns=self._start, dur_ns=end - self._start,
            cpu_ns=cpu, tid=threading.get_ident(),
            parent=None if parent is None else parent.name, depth=self._depth,
            args=self.args, span_id=self._id,
            parent_id=None if parent is None else parent._id,
        ), None if events is None else events[:2])
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
        self._ids = itertools.count(1)
        self._pending: List[Tuple[int, Any, Any]] = []   # (record index, entry, exit event)
        self._free: List[Any] = []                        # resolved events, for reuse
        self.take_anchor()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord, events: Optional[Tuple[Any, Any]] = None) -> None:
        if len(self.records) >= self.max_spans:
            self.dropped += 1
            return
        if events is not None:
            self._pending.append((len(self.records), *events))
        self.records.append(rec)

    def _device_events(self):
        """``(entry, exit, stream)``: two timing events, reused once resolved,
        and the current stream, the entry event recorded on it; ``None``
        when CUDA is not initialized. The first pair after CUDA came up
        takes the anchor's event first."""
        torch = _cuda()
        if torch is None:
            return None
        if self.anchor.event is None:
            self.take_anchor()
        start, end = self._event(torch), self._event(torch)
        stream = torch.cuda.current_stream()
        start.record(stream)
        return start, end, stream

    def _event(self, torch):
        try:
            return self._free.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def take_anchor(self) -> Anchor:
        """Pair the span clock with the Unix-epoch clock and, when CUDA is
        initialized, with an event recorded on an idle stream."""
        torch = _cuda()
        event = device = None
        if torch is not None:
            torch.cuda.synchronize()
            device = torch.cuda.current_device()
            event = torch.cuda.Event(enable_timing=True)
            event.record()
        self.anchor = Anchor(time.perf_counter_ns(), time.time_ns(), event, device)
        return self.anchor

    def span(self, name: str, /, **args) -> _Span:
        return _Span(self, name, args)

    def device_span(self, name: str, /, **args) -> _Span:
        """:meth:`span` with the stream time between its entry and exit."""
        return _Span(self, name, args, device=True)

    def resolve(self) -> List[SpanRecord]:
        """Fill in the device times of the finished device spans (this
        waits for their exit events) and return the records."""
        anchor = self.anchor
        for i, start, end in self._pending:
            end.synchronize()
            at = None
            if anchor.event is not None:
                try:
                    at = anchor.perf_ns + round(anchor.event.elapsed_time(start) * 1e6)
                except RuntimeError:          # recorded on another device
                    pass
            self.records[i] = self.records[i]._replace(
                device_ns=round(start.elapsed_time(end) * 1e6), device_start_ns=at)
            self._free += (start, end)
        self._pending = []
        return self.records

    def reset(self) -> None:
        self.records = []
        self.dropped = 0
        self._pending = []
        self._local = threading.local()
        self.take_anchor()

    # -- export -------------------------------------------------------------

    def to_chrome(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (loadable in chrome://tracing/Perfetto).

        ``ts`` is each span's start offset from the earliest recorded span
        in microseconds (Chrome wants a common, smallish time base);
        ``dur`` is the wall duration; CPU time, parent and depth ride in
        ``args`` alongside the caller's attributes. A span with device time
        has a second event on the device's track (tid ``DEVICE_TID`` less
        the device index). ``otherData["clock"]`` gives the base and the
        anchor: a ``ts`` is ``base_ns + 1e3 * ts - perf_ns + unix_ns`` on
        the Unix-epoch clock of a Kineto trace.
        """
        records = self.resolve()
        pid = os.getpid()
        base = min((r.start_ns for r in records), default=0)
        anchor = self.anchor
        dev_tid = DEVICE_TID - (anchor.device or 0)
        events = []
        for r in records:
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
            if r.device_start_ns is not None:
                events.append({
                    "name": r.name,
                    "cat": "repro_torch.device",
                    "ph": "X",
                    "ts": (r.device_start_ns - base) / 1e3,
                    "dur": r.device_ns / 1e3,
                    "pid": pid,
                    "tid": dev_tid,
                    "args": args,
                })
        if any(r.device_start_ns is not None for r in records):
            events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": dev_tid,
                           "args": {"name": f"cuda:{anchor.device} stream time"}})
        meta: Dict[str, Any] = {
            "dropped_spans": self.dropped,
            "clock": {"base_ns": base, "perf_ns": anchor.perf_ns, "unix_ns": anchor.unix_ns},
        }
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": meta}
