"""Structured JSONL event sink.

Events are timestamped dicts collected in a bounded in-memory buffer and
written out as ``.jsonl`` (one JSON object per line) with the run's other
artifacts. Each carries ``ts`` (Unix-epoch seconds) and ``t_ns``
(``perf_counter_ns``, the clock the tracer stamps spans with). The sink is
only fed when telemetry is enabled (:mod:`repro_torch.telemetry` gates it),
so the disabled path never touches it.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List

__all__ = ["EventSink"]


class EventSink:
    """Bounded event buffer."""

    def __init__(self, max_events: int = 100_000):
        self.max_events = int(max_events)
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0

    def emit(self, name: str, **fields: Any) -> None:
        evt = {"event": name, "ts": time.time(), "t_ns": time.perf_counter_ns(), **fields}
        if len(self.events) < self.max_events:
            self.events.append(evt)
        else:
            self.dropped += 1

    def write_jsonl(self, path: str) -> None:
        """Dump the buffered events to ``path`` (one object per line)."""
        with open(path, "w") as f:
            for evt in self.events:
                f.write(json.dumps(evt, default=str) + "\n")

    def reset(self) -> None:
        self.events = []
        self.dropped = 0
