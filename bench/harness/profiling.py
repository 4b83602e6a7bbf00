"""One call of the program under ``torch.profiler`` (CPU and CUDA), read
into what the per-layer metrics and the result's breakdown need: the
device's busy and idle time over the call, device time by kernel name,
device time under each CPU op by name (its children's kernels included), and
the longest idle gaps, each named by the program's telemetry span open on
the host when the gap began.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

MARK = "bench.call"
TOP = 10


@dataclass
class Profile:
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]                   # (name, seconds), device ops
    op_device: Dict[str, float] = field(default_factory=dict)   # CPU op name -> device s
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel_durations(self, part: str) -> List[float]:
        """Durations (s) of the device ops whose name holds ``part``."""
        return [d for name, d in self.kernels if part in name]

    def device_ops(self) -> List[List]:
        by: Dict[str, float] = {}
        for name, d in self.kernels:
            by[name] = by.get(name, 0.0) + d
        return [[n[:160], s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def _merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _span_at(t_us: float, spans: Sequence[Tuple[float, float, int, str]]) -> str:
    """The innermost span open at ``t_us`` (profiler microseconds)."""
    best: Optional[Tuple[int, str]] = None
    for a, b, depth, name in spans:
        if a <= t_us < b and (best is None or depth > best[0]):
            best = (depth, name)
    return best[1] if best else "outside spans"


def profile_call(fn: Callable[[], object], spans_of: Callable[[], list],
                 device="cuda") -> Tuple[object, Profile]:
    """Run ``fn`` once under the profiler and synchronize. ``spans_of()``
    returns the telemetry span records recorded meanwhile (their
    ``start_ns``/``dur_ns`` on ``perf_counter_ns``). On a CPU device (the
    harness's own tests) only the host is traced."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(MARK):
            host0 = time.perf_counter_ns()
            out = fn()
            if cuda:
                torch.cuda.synchronize(device)
    events = prof.events()
    mark = [e for e in events if e.name == MARK]
    if not mark:
        raise RuntimeError("the profiler recorded no call mark")
    start = mark[0].time_range.start
    end = mark[0].time_range.end
    # the mark's own annotation on the device timeline is no device work
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name != MARK]
    if device:
        end = max(end, max(e.time_range.end for e in device))
    kernels = [(e.name, (e.time_range.end - e.time_range.start) / 1e6) for e in device]
    busy_iv = _merge([(max(e.time_range.start, start), min(e.time_range.end, end))
                      for e in device if e.time_range.end > start])
    busy = sum(b - a for a, b in busy_iv) / 1e6
    window = (end - start) / 1e6

    offset = start - host0 / 1e3
    spans = [(r.start_ns / 1e3 + offset, (r.start_ns + r.dur_ns) / 1e3 + offset, r.depth, r.name)
             for r in spans_of()]
    edges = [start] + [x for iv in busy_iv for x in iv] + [end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[_span_at(a, spans), (b - a) / 1e6] for a, b in gaps[:TOP]]

    op_device: Dict[str, float] = {}
    for e in events:
        if e.device_type == DeviceType.CPU and e.device_time_total > 0:
            op_device[e.name] = op_device.get(e.name, 0.0) + e.device_time_total / 1e6
    return out, Profile(window_s=window, busy_s=busy, kernels=kernels, op_device=op_device,
                        gaps=named)
