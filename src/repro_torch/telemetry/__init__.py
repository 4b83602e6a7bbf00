"""repro_torch.telemetry — spans, events, metrics and run manifests.

The port's copy of ``repro.telemetry``:

* **Spans** — ``with telemetry.span("round", round=t): ...`` nest through
  a thread-local stack (:class:`~repro_torch.telemetry.tracing.Tracer`),
  time wall and process CPU, and export as Chrome-trace JSON.
  ``device_span`` adds the stream time between CUDA events at entry and
  exit, once CUDA is up; the spans of one call share the id
  :func:`call_id` hands out (their ``call`` attribute). Off by default: a
  disabled ``span()`` or ``device_span()`` returns a shared no-op context
  manager.
* **Events** — a bounded structured sink (``telemetry.event(...)``), fed
  only when enabled, stamped on the spans' clock (``t_ns``) as well.
* **Metrics** — the counters, gauges and histograms of
  :mod:`repro_torch.telemetry.metrics`, always live.
* **Manifests** — :func:`manifest` builds the per-run provenance block
  (:mod:`repro_torch.telemetry.manifest`) that ``build_result`` and
  serving bundles attach.

``enable(out_dir)`` (or ``configure(enabled=True, out_dir=...)``) turns
spans and events on and, with ``out_dir``, writes the run's artifacts there
at process exit (:func:`write_run`: trace.json, metrics.json,
manifest.json, events.jsonl). The reference's environment switch applies
at import: ``REPRO_TELEMETRY`` set to 1, true, yes or on enables, and
``REPRO_TELEMETRY_DIR`` then names the out dir.
"""
from __future__ import annotations

import atexit
import itertools
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
    "EventSink", "NULL_SPAN", "SpanRecord", "Tracer", "build_manifest", "call_id",
    "config_hash", "configure", "counter", "device_span", "disable", "enable", "enabled",
    "event", "events",
    "export_chrome_trace", "gauge", "histogram", "manifest", "metrics",
    "metrics_snapshot", "records", "reset", "span", "tracer", "write_run",
]

_enabled = False
_out_dir: Optional[str] = None
_atexit_registered = False

tracer = Tracer()
_events = EventSink()
_calls = itertools.count(1)


def enabled() -> bool:
    return _enabled


def enable(out_dir: Optional[str] = None) -> None:
    """Turn spans and events on (metrics are always live). With
    ``out_dir``, the run artifacts are written there at process exit (and
    by any explicit :func:`write_run` call). Takes the tracer's clock
    anchor."""
    global _enabled, _out_dir, _atexit_registered
    _enabled = True
    tracer.take_anchor()
    if out_dir is not None:
        _out_dir = out_dir
        if not _atexit_registered:
            atexit.register(_write_run_atexit)
            _atexit_registered = True


def disable() -> None:
    global _enabled
    _enabled = False


def configure(*, enabled: bool, out_dir: Optional[str] = None) -> None:
    if enabled:
        enable(out_dir)
    else:
        disable()


def reset(reset_metrics: bool = False) -> None:
    """Drop the recorded spans and events, and with ``reset_metrics`` zero
    every metric of the registry (registrations are kept)."""
    tracer.reset()
    _events.reset()
    if reset_metrics:
        metrics.registry().reset()


def records() -> List[SpanRecord]:
    """The spans recorded since the last :func:`reset`, in finish order,
    their device times resolved (which waits for the device spans' exit
    events)."""
    return list(tracer.resolve())


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


def device_span(name: str, /, **args):
    """:func:`span` that also records the stream time between its entry
    and exit (``SpanRecord.device_ns``) once CUDA is initialized; for the
    boundaries that launch device work. Never initializes CUDA."""
    if not _enabled:
        return NULL_SPAN
    return tracer.device_span(name, **args)


def call_id() -> int:
    """A fresh id for the spans of one call: the ``call`` attribute of its
    top-level spans, which the spans inside inherit."""
    return next(_calls)


def event(name: str, /, **fields) -> None:
    """Record a structured event ``{"event": name, "ts": ..., "t_ns": ..., **fields}``
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


# The reference's activation at import (repro/telemetry/__init__.py).
_env = os.environ.get("REPRO_TELEMETRY", "").strip().lower()
if _env in ("1", "true", "yes", "on"):
    enable(os.environ.get("REPRO_TELEMETRY_DIR") or None)
del _env
