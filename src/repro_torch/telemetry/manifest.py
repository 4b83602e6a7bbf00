"""Per-run manifests: the provenance block attached to results and bundles.

The port of ``repro/telemetry/manifest.py``. A manifest answers "what
produced this number?" without rerunning anything: a content hash of the
exact config (:func:`config_hash`, equal to the reference's on the same
config), the execution backend and mesh, the port's one compilation (the
CUDA kernel builds of ``kernels/_build.py`` this process ran, under the
reference's ``jit_compiles`` / ``jit_compile_seconds`` keys), the
versions of python, torch, CUDA and numpy, and the devices torch and
``torch.distributed`` report. It is plain JSON-serializable data, attached
to every Trainer result (``result["manifest"]``) and serving bundle
(``meta["manifest"]``) whether or not tracing is enabled.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
import time
from typing import Any, Dict, Optional

import numpy
import torch

from repro_torch._device import process_count

__all__ = ["config_hash", "build_manifest", "reference_fields"]


def reference_fields(obj: Any) -> Dict[str, Any]:
    """A config dataclass's fields by name, less those marked ``port_only``
    in their metadata (settings the reference lacks) while they hold their
    default: a config the reference can express gives the reference's
    fields."""
    return {
        f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
        if not (f.metadata.get("port_only") and getattr(obj, f.name) == f.default)
    }


def _jsonable(obj: Any) -> Any:
    """A deterministic JSON-friendly form of a (possibly nested dataclass)
    config object."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _jsonable(v) for k, v in reference_fields(obj).items()}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def config_hash(cfg: Any) -> str:
    """sha1 of the config's canonical JSON form — equal configs hash
    equal across processes and sessions, any field change changes it."""
    blob = json.dumps(_jsonable(cfg), sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()


def _package_versions() -> Dict[str, str]:
    return {
        "python": platform.python_version(),
        "torch": str(torch.__version__),
        "cuda": str(torch.version.cuda),
        "numpy": str(numpy.__version__),
    }


def _devices() -> Dict[str, Any]:
    cuda = torch.cuda.is_available()
    return {
        "device_count": torch.cuda.device_count() if cuda else 0,
        "device_name": torch.cuda.get_device_name(torch.cuda.current_device()) if cuda else None,
        "process_count": process_count(),
    }


def build_manifest(
    cfg: Any = None,
    *,
    mesh: Optional[Dict[str, Any]] = None,
    extra: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Assemble the run manifest.

    ``cfg`` is any (dataclass) config — hashed, with its ``backend`` field
    surfaced when present. ``mesh`` is an already-serialized mesh
    description (``trainer.mesh_description``'s dict).
    """
    from repro_torch import telemetry  # late: telemetry imports this module
    from repro_torch.kernels import _build

    m: Dict[str, Any] = {
        "created_unix": time.time(),
        "telemetry_enabled": telemetry.enabled(),
        "jit_compiles": len(_build.build_info),
        "jit_compile_seconds": float(sum(i["seconds"] for i in _build.build_info.values())),
        "versions": _package_versions(),
        "platform": platform.platform(),
        **_devices(),
    }
    if cfg is not None:
        m["config_hash"] = config_hash(cfg)
        backend = getattr(cfg, "backend", None)
        if backend is not None:
            m["backend"] = str(backend)
    if mesh is not None:
        m["mesh"] = mesh
    if extra:
        m.update(extra)
    return m
