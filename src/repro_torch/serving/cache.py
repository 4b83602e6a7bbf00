"""Per-client pack cache for the graph inference server.

The port of ``repro/serving/cache.py`` without persistence. Each client's
entry is keyed on a *fingerprint* of everything a pack depends on — node
features, the CSR arrays, the client's edge-visibility mask, the engine and
the per-client pack key — so a changed graph is a miss and an unchanged one
a hit. Under the pack-free engines of this package the entry's payload is
``None`` and the cache does the accounting of which client views are valid.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, Hashable, Optional

import numpy as np

from repro_torch.telemetry.metrics import counter as _metrics_counter

# Process-wide accounting: every PackCache instance feeds these; the
# per-instance attributes are the per-cache view.
_HITS = _metrics_counter("serving.pack_cache.hits")
_MISSES = _metrics_counter("serving.pack_cache.misses")
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


class PackCache:
    """LRU cache of per-client packs with hit/miss/eviction accounting.

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

    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }
