"""Structured JSONL event sink.

Events are timestamped dicts collected in a bounded in-memory buffer and
optionally mirrored to a ``.jsonl`` file as they happen (one JSON object
per line — greppable while a run is live, parseable after). The sink is
only fed when telemetry is enabled (:mod:`repro_torch.telemetry` gates it), so
the disabled path never touches it.
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

__all__ = ["EventSink"]


class EventSink:
    """Bounded event buffer with optional live JSONL mirroring."""

    def __init__(self, max_events: int = 100_000):
        self.max_events = int(max_events)
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self._file = None

    def open_file(self, path: str) -> None:
        """Mirror subsequent events to ``path`` (line-buffered JSONL)."""
        self.close()
        self._file = open(path, "a", buffering=1)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def emit(self, name: str, **fields: Any) -> None:
        evt = {"event": name, "ts": time.time(), **fields}
        if len(self.events) < self.max_events:
            self.events.append(evt)
        else:
            self.dropped += 1
        if self._file is not None:
            self._file.write(json.dumps(evt, default=str) + "\n")

    def write_jsonl(self, path: str) -> None:
        """Dump the buffered events to ``path`` (one object per line)."""
        with open(path, "w") as f:
            for evt in self.events:
                f.write(json.dumps(evt, default=str) + "\n")

    def reset(self) -> None:
        self.events = []
        self.dropped = 0
