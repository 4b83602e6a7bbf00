"""repro_torch.telemetry — spans, events, metrics and run manifests.

The port's copy of ``repro.telemetry``:

* **Spans** — ``with telemetry.span("round", round=t): ...`` nest through
  a thread-local stack (:class:`~repro_torch.telemetry.tracing.Tracer`),
  time wall and process CPU, and export as Chrome-trace JSON. Off by
  default: a disabled ``span()`` returns a shared no-op context manager.
* **Events** — a bounded structured sink (``telemetry.event(...)``), fed
  only when enabled.
* **Metrics** — the counters, gauges and histograms of
  :mod:`repro_torch.telemetry.metrics`, always live.
* **Manifests** — :func:`manifest` builds the per-run provenance block
  (:mod:`repro_torch.telemetry.manifest`) that ``build_result`` and
  serving bundles attach.

``enable(out_dir)`` turns spans and events on and, with ``out_dir``,
writes the run's artifacts there at process exit (:func:`write_run`:
trace.json, metrics.json, manifest.json, events.jsonl).
"""
from __future__ import annotations

import atexit
import json
import os
import sys
from typing import Any, Dict, List, Optional

from repro_torch.telemetry import metrics as metrics
from repro_torch.telemetry.manifest import build_manifest, config_hash
from repro_torch.telemetry.metrics import counter, gauge, histogram
from repro_torch.telemetry.sink import EventSink
from repro_torch.telemetry.tracing import NULL_SPAN, SpanRecord, Tracer

__all__ = [
    "EventSink", "NULL_SPAN", "SpanRecord", "Tracer", "build_manifest", "config_hash",
    "counter", "disable", "enable", "enabled", "event", "events",
    "export_chrome_trace", "gauge", "histogram", "manifest", "metrics",
    "metrics_snapshot", "records", "reset", "span", "tracer", "write_run",
]

_enabled = False
_out_dir: Optional[str] = None
_atexit_registered = False

tracer = Tracer()
_events = EventSink()


def enabled() -> bool:
    return _enabled


def enable(out_dir: Optional[str] = None) -> None:
    """Turn spans and events on (metrics are always live). With
    ``out_dir``, the run artifacts are written there at process exit (and
    by any explicit :func:`write_run` call)."""
    global _enabled, _out_dir, _atexit_registered
    _enabled = True
    if out_dir is not None:
        _out_dir = out_dir
        if not _atexit_registered:
            atexit.register(_write_run_atexit)
            _atexit_registered = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop the recorded spans and events."""
    tracer.reset()
    _events.reset()


def records() -> List[SpanRecord]:
    """The spans recorded since the last :func:`reset`, in finish order."""
    return list(tracer.records)


def events() -> List[Dict[str, Any]]:
    """The events recorded since the last :func:`reset`, in order."""
    return list(_events.events)


def span(name: str, /, **args):
    """A timed, nested span when telemetry is enabled; a shared no-op
    context manager when disabled (the default). ``name`` is
    positional-only so ``name=...`` stays usable as a span attribute."""
    if not _enabled:
        return NULL_SPAN
    return tracer.span(name, **args)


def event(name: str, /, **fields) -> None:
    """Record a structured event ``{"event": name, "ts": ..., **fields}``
    when telemetry is enabled; a no-op when disabled (the default)."""
    if _enabled:
        _events.emit(name, **fields)


def metrics_snapshot() -> Dict[str, Dict[str, Any]]:
    return metrics.snapshot()


def manifest(cfg: Any = None, *, mesh: Optional[Dict[str, Any]] = None,
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The per-run provenance manifest (see telemetry.manifest)."""
    return build_manifest(cfg, mesh=mesh, extra=extra)


def export_chrome_trace(path: Optional[str] = None) -> Dict[str, Any]:
    """The collected spans as a Chrome-trace JSON object; written to
    ``path`` when given."""
    trace = tracer.to_chrome()
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def write_run(out_dir: str, cfg: Any = None) -> Dict[str, str]:
    """Write the run artifact set under ``out_dir``: ``trace.json``
    (Chrome trace), ``metrics.json`` (registry snapshot), ``manifest.json``
    (provenance), ``events.jsonl`` (structured events). Returns
    {artifact: path}."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "trace": os.path.join(out_dir, "trace.json"),
        "metrics": os.path.join(out_dir, "metrics.json"),
        "manifest": os.path.join(out_dir, "manifest.json"),
        "events": os.path.join(out_dir, "events.jsonl"),
    }
    export_chrome_trace(paths["trace"])
    with open(paths["metrics"], "w") as f:
        json.dump(metrics_snapshot(), f, indent=1, default=str)
    with open(paths["manifest"], "w") as f:
        json.dump(manifest(cfg), f, indent=1, default=str)
    _events.write_jsonl(paths["events"])
    return paths


def _write_run_atexit() -> None:
    if _enabled and _out_dir:
        try:
            write_run(_out_dir)
        except Exception as err:  # never fail interpreter shutdown
            print(f"repro_torch.telemetry: atexit write failed: {err}", file=sys.stderr)
