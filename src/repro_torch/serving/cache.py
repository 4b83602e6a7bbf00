"""Per-client pack cache for the graph inference server.

The port of ``repro/serving/cache.py``. The FedGAT pack is the one-shot
pre-communicated artifact that makes federated graph inference cheap:
building it costs O(N d g^2) while serving from it is a few batched
matmuls. Each client's entry is keyed on a *fingerprint* of everything the
pack depends on — node features, the CSR arrays, the client's
edge-visibility mask, the engine and the per-client pack key — so a
changed graph is a miss, an unchanged one a hit, and an incrementally
patched pack stays servable under the fingerprint of the graph it was
patched to. Pack-free engines keep a ``None`` payload.

A cache persists to a directory (:meth:`PackCache.save`,
:meth:`PackCache.load`) in the reference's format, so a cache written by
either package loads in the port.
"""
from __future__ import annotations

import hashlib
import json
import os
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, Optional

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.fedgat_matrix import FedGATPack
from repro_torch.core.fedgat_vector import VectorPack
from repro_torch.telemetry.metrics import counter as _metrics_counter

_INDEX_NAME = "cache_index.json"
_FORMAT_VERSION = 1
# The pack types a saved payload may name, by class name. The module in a
# saved type string is never imported: a cache written by the reference
# names ``repro.core.fedgat_matrix:FedGATPack`` and loads as the port's.
_PACK_TYPES = {cls.__name__: cls for cls in (FedGATPack, VectorPack)}

# Process-wide accounting: every PackCache instance feeds these; the
# per-instance attributes are the per-cache view (and survive save/load).
_HITS = _metrics_counter("serving.pack_cache.hits")
_MISSES = _metrics_counter("serving.pack_cache.misses")
_PATCHES = _metrics_counter("serving.pack_cache.patches")
_REFRESHES = _metrics_counter("serving.pack_cache.refreshes")
_EVICTIONS = _metrics_counter("serving.pack_cache.evictions")


def graph_fingerprint(*arrays: Any, extra: tuple = ()) -> str:
    """Content hash of the graph arrays a pack was built from.

    Arrays are hashed as (shape, dtype, bytes); ``extra`` mixes in
    non-array provenance (engine name, r, key bytes, ...).
    """
    hsh = hashlib.sha1()
    for a in arrays:
        a = np.asarray(a)
        hsh.update(str(a.shape).encode())
        hsh.update(str(a.dtype).encode())
        hsh.update(np.ascontiguousarray(a).tobytes())
    for e in extra:
        hsh.update(repr(e).encode())
    return hsh.hexdigest()


@dataclass
class PackEntry:
    """One client's cached pack + the fingerprint it is valid for."""

    pack: Any                      # engine payload (None for pack-free engines)
    fingerprint: str
    patched: bool = False          # True once an incremental patch was applied
    builds: int = 1                # full precomputes that produced this slot
    meta: Dict[str, Any] = field(default_factory=dict)


def _host_array(a: Any) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class PackCache:
    """LRU cache of per-client packs with hit/miss/patch/refresh accounting.

    ``capacity`` bounds the number of resident client entries (None =
    unbounded); eviction is least-recently-used.
    """

    def __init__(self, capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._entries: "OrderedDict[Hashable, PackEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.patches = 0
        self.refreshes = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, client: Hashable) -> bool:
        return client in self._entries

    def get(self, client: Hashable, fingerprint: str) -> Optional[PackEntry]:
        """The client's entry if it matches ``fingerprint`` (a hit), else
        None (a miss — stale or absent entries both count as misses)."""
        entry = self._entries.get(client)
        if entry is not None and entry.fingerprint == fingerprint:
            self.hits += 1
            _HITS.inc()
            self._entries.move_to_end(client)
            return entry
        self.misses += 1
        _MISSES.inc()
        return None

    def touch(self, client: Hashable) -> None:
        """Count a serve from an already-validated resident entry as a hit
        (the server's per-version logits memo skips the fingerprint check,
        but the pack is still what answered the query)."""
        if client in self._entries:
            self.hits += 1
            _HITS.inc()
            self._entries.move_to_end(client)

    def peek(self, client: Hashable) -> Optional[PackEntry]:
        """The client's entry regardless of fingerprint (no accounting)."""
        return self._entries.get(client)

    def put(self, client: Hashable, entry: PackEntry) -> None:
        """Install a freshly built entry (evicting LRU if over capacity)."""
        self._entries[client] = entry
        self._entries.move_to_end(client)
        while self.capacity is not None and len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.evictions += 1
            _EVICTIONS.inc()

    def revalidate(self, client: Hashable, fingerprint: str) -> None:
        """Re-stamp an entry for a new fingerprint without touching the
        payload — pack-free engines absorb graph deltas exactly, so their
        (empty) entry just follows the graph."""
        self._entries[client].fingerprint = fingerprint

    def note_patch(self, client: Hashable, fingerprint: str, pack: Any) -> None:
        """Record an incremental patch: the entry now serves ``fingerprint``."""
        entry = self._entries[client]
        entry.pack = pack
        entry.fingerprint = fingerprint
        entry.patched = True
        self.patches += 1
        _PATCHES.inc()

    def note_refresh(self, client: Hashable, fingerprint: str, pack: Any) -> None:
        """Record a full rebuild of the client's pack (bound crossed or
        forced): the entry is fresh again."""
        entry = self._entries.get(client)
        if entry is None:
            entry = PackEntry(pack=pack, fingerprint=fingerprint, builds=0)
            self._entries[client] = entry
        entry.pack = pack
        entry.fingerprint = fingerprint
        entry.patched = False
        entry.builds += 1
        self.refreshes += 1
        _REFRESHES.inc()

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "patches": self.patches,
            "refreshes": self.refreshes,
            "evictions": self.evictions,
        }

    # -- persistence --------------------------------------------------------
    #
    # A cache directory holds one JSON index (entry metadata + counters, in
    # LRU order) plus one .npz per pack payload. Payloads are validated by a
    # content digest on load, and every entry keeps its *graph* fingerprint,
    # so a reloaded entry serves if and only if the original would have: a
    # server restarted against a changed graph takes ordinary misses.

    def save(self, directory: str) -> Dict[str, Any]:
        """Persist entries + counters to ``directory`` (created if absent).

        Pack payloads must be NamedTuples of tensors or arrays (every
        registered pack-building engine's payload is) or None; clients must
        be JSON-representable keys (ints in practice).
        """
        os.makedirs(directory, exist_ok=True)
        entries = []
        for i, (client, e) in enumerate(self._entries.items()):
            payload = None
            if e.pack is not None:
                fields = list(type(e.pack)._fields)
                arrays = {f: _host_array(getattr(e.pack, f)) for f in fields}
                fname = f"pack_{i:05d}.npz"
                np.savez(os.path.join(directory, fname), **arrays)
                payload = {
                    "type": f"{type(e.pack).__module__}:{type(e.pack).__qualname__}",
                    "file": fname,
                    "fields": fields,
                    "digest": graph_fingerprint(*(arrays[f] for f in fields)),
                }
            entries.append({
                "client": client,
                "fingerprint": e.fingerprint,
                "patched": e.patched,
                "builds": e.builds,
                "meta": e.meta,
                "payload": payload,
            })
        index = {
            "version": _FORMAT_VERSION,
            "capacity": self.capacity,
            "counters": {
                "hits": self.hits, "misses": self.misses,
                "patches": self.patches, "refreshes": self.refreshes,
                "evictions": self.evictions,
            },
            "entries": entries,
        }
        with open(os.path.join(directory, _INDEX_NAME), "w") as f:
            json.dump(index, f, indent=1)
        return index

    @classmethod
    def load(cls, directory: str, *, device: DeviceLike = None) -> "PackCache":
        """Rebuild a cache saved by :meth:`save` (of either package), its
        packs on ``device`` (default ``cuda``).

        Every payload's content digest is recomputed and checked — a
        corrupted or tampered .npz raises instead of silently serving a
        wrong pack. The pack type is resolved by class name among the
        port's pack types. Entry order (LRU) and counters survive the
        round trip.
        """
        dev = resolve_device(device)
        with open(os.path.join(directory, _INDEX_NAME)) as f:
            index = json.load(f)
        if index.get("version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported cache format version {index.get('version')!r} "
                f"(this build reads version {_FORMAT_VERSION})"
            )
        cache = cls(capacity=index.get("capacity"))
        for rec in index["entries"]:
            pack = None
            payload = rec.get("payload")
            if payload is not None:
                with np.load(os.path.join(directory, payload["file"])) as z:
                    arrays = {f: z[f] for f in payload["fields"]}
                digest = graph_fingerprint(
                    *(arrays[f] for f in payload["fields"])
                )
                if digest != payload["digest"]:
                    raise ValueError(
                        f"pack payload {payload['file']!r} failed its content "
                        f"digest check (stored {payload['digest'][:12]}..., "
                        f"recomputed {digest[:12]}...) — refusing to load a "
                        "corrupted pack"
                    )
                name = payload["type"].rpartition(":")[2].rpartition(".")[2]
                pack_type = _PACK_TYPES.get(name)
                if pack_type is None or list(pack_type._fields) != list(payload["fields"]):
                    raise ValueError(
                        f"pack payload {payload['file']!r} has type "
                        f"{payload['type']!r}, which is not one of the port's "
                        f"pack types {sorted(_PACK_TYPES)}"
                    )
                pack = pack_type(**{
                    f: (torch.from_numpy(a).to(dev) if a.ndim else float(a))
                    for f, a in arrays.items()
                })
            cache._entries[rec["client"]] = PackEntry(
                pack=pack, fingerprint=rec["fingerprint"],
                patched=rec["patched"], builds=rec["builds"],
                meta=dict(rec.get("meta") or {}),
            )
        for name, value in index.get("counters", {}).items():
            setattr(cache, name, int(value))
        return cache
