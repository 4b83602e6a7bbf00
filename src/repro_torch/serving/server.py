"""GraphInferenceServer — online node classification over a trained FedGAT.

The port of ``repro/serving/server.py``. The unit of work is one layered
forward per (client, graph version): a microbatch's queries are grouped by
client, each distinct client costs one forward (through the fused CUDA
``cheb_attn`` kernel under ``engine="kernel"``), and per-query logits are
gathered from it. Packs are cached per client
(:class:`~repro_torch.serving.cache.PackCache`), graph deltas are absorbed
with cheap local pack patches, and the accumulated drift is tracked against
the paper's Thm 3.5 logit bound — a full per-client pack refresh fires only
when the bound is crossed.

Unlike the reference, the server never substitutes one engine for another:
``engine="kernel"`` on the GPU launches the kernel or raises, and
``stats()["engine_fallback"]`` is always ``None``.
"""
from __future__ import annotations

import copy
import os
from dataclasses import dataclass, field, replace
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import telemetry
from repro_torch._device import DeviceLike, resolve_device
from repro_torch._rng import fold_in, generator
from repro_torch.analysis.error_bounds import thm35_logit_bound
from repro_torch.core.engine import get_engine
from repro_torch.core.fedgat_model import FedGATConfig, graph_tensors, layered_forward
from repro_torch.federated.partition import Partition, client_neighbor_masks, dirichlet_partition
from repro_torch.graphs.graph import Graph
from repro_torch.serving.cache import PackCache, PackEntry, graph_fingerprint
from repro_torch.serving.checkpoint import load_bundle
from repro_torch.serving.updates import (
    Coverage,
    GraphDelta,
    apply_delta,
    extend_coverage,
    initial_coverage,
    mass_drift,
    patch_pack,
)

SERVABLE_METHODS = ("fedgat", "distgat")
PATCH_STREAM = 10_000       # patch generators: stream PATCH_STREAM + graph version


class Query(NamedTuple):
    client: int
    node: int


class QueryResult(NamedTuple):
    client: int
    node: int
    logits: np.ndarray      # (C,)
    label: int              # argmax class


def client_pack_key(seed: int, client: int) -> np.ndarray:
    """Deterministic per-client pack key, as two uint32 words.

    The reference folds the client into a JAX PRNG key
    (``jax.random.fold_in``); the port hashes ``(seed, client)`` with
    splitmix64 instead (:func:`repro_torch._rng.fold_in`) and seeds the
    client's pack generator with it, so a refresh rebuilds bit for bit what
    a from-scratch precompute under the same key gives on the same device.
    """
    z = fold_in(seed, client)
    return np.array([z >> 32, z & 0xFFFFFFFF], dtype=np.uint32)


def _key_int(key: np.ndarray) -> int:
    return (int(key[0]) << 32) | int(key[1])


@dataclass
class ClientState:
    """Server-side drift bookkeeping for one client's cached pack."""

    covered: Optional[Coverage] = None     # sparse slot set the pack encodes
    b_pack: int = 0                        # pack's padded-degree capacity
    eps: float = 0.0                       # tracked Thm 3.5 score-mass error
    refreshes: int = 0
    patches: int = 0
    history: List[float] = field(default_factory=list)  # eps after each delta


class GraphInferenceServer:
    """Serve node-classification queries from a trained FedGAT checkpoint.

    Typical use::

        server = GraphInferenceServer.from_checkpoint("ckpt/", graph)
        results = server.serve_batch([Query(client=0, node=17), ...])
        server.apply_update(GraphDelta(features=new_h, edges=new_e))

    ``device`` defaults to ``cuda`` and raises when no card is present;
    pass ``device="cpu"`` to serve through the plain PyTorch versions.
    """

    def __init__(
        self,
        params: nn.ModuleList,
        model_cfg: FedGATConfig,
        graph: Graph,
        *,
        method: str = "fedgat",
        num_clients: int = 1,
        partition: Optional[Partition] = None,
        engine: Optional[str] = None,
        pack_seed: int = 0,
        refresh_threshold: float = 2.0,
        cache: Optional[PackCache] = None,
        cache_dir: Optional[str] = None,
        privacy: Optional[Dict[str, Any]] = None,
        meta: Optional[Dict[str, Any]] = None,
        device: DeviceLike = None,
    ):
        if method not in SERVABLE_METHODS:
            raise ValueError(
                f"method {method!r} is not servable; supported: {SERVABLE_METHODS}"
            )
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
        if refresh_threshold <= 0:
            raise ValueError(f"refresh_threshold must be > 0, got {refresh_threshold}")
        self.device = resolve_device(device)
        self.cfg = replace(model_cfg, engine=engine or model_cfg.engine)
        self.engine = get_engine(self.cfg.engine)(self.cfg)
        self.engine_fallback = None
        self.coeffs: Optional[torch.Tensor] = (
            torch.as_tensor(self.cfg.coeffs(), dtype=torch.float32, device=self.device)
            if self.engine.needs_coeffs else None
        )
        if any(p.device != self.device for p in params.parameters()):
            params = copy.deepcopy(params).to(self.device)   # leave the caller's in place
        self.params = params
        self.method = method
        self.num_clients = int(num_clients)
        self.part = partition
        if method == "distgat":
            if self.part is None:
                raise ValueError(
                    "serving the distgat method needs the training Partition "
                    "(per-client edge visibility); pass partition= or use "
                    "from_checkpoint, which rebuilds it from bundle provenance"
                )
            if self.part.num_clients != self.num_clients:
                raise ValueError(
                    f"partition has {self.part.num_clients} clients, "
                    f"server configured for {self.num_clients}"
                )
        self.pack_seed = int(pack_seed)
        self.refresh_threshold = float(refresh_threshold)
        # cache_dir makes the pack cache survive server restarts: a saved
        # cache there is reloaded (fingerprint-validated) onto this server's
        # device, and save_cache() writes back to the same place. Entries
        # reloaded against a changed graph/engine simply miss.
        self.cache_dir = cache_dir
        if cache is not None:
            self.cache = cache
        elif cache_dir is not None and os.path.exists(
            os.path.join(cache_dir, "cache_index.json")
        ):
            self.cache = PackCache.load(cache_dir, device=self.device)
        else:
            self.cache = PackCache()
        self.privacy = dict(privacy or {})
        self.meta = dict(meta or {})
        self._clients: Dict[int, ClientState] = {}
        self._version = 0
        self._logits_memo: Dict[int, Tuple[int, np.ndarray]] = {}
        self._vis_memo: Dict[int, Tuple[np.ndarray, torch.Tensor]] = {}
        self._set_graph(graph)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_checkpoint(
        cls, path: str, graph: Graph, *, device: DeviceLike = None, **kwargs
    ) -> "GraphInferenceServer":
        """Load a bundle written by either package's ``save_bundle`` and
        serve it. Method and num_clients come from the bundle; for DistGAT
        bundles the training partition is rebuilt from the recorded
        (beta, seed) so per-client edge visibility matches what the clients
        trained under. Keyword overrides win."""
        dev = resolve_device(device)
        bundle = load_bundle(path, graph, device=dev)
        meta = bundle.meta
        method = kwargs.pop("method", meta.get("method", "fedgat"))
        num_clients = kwargs.pop("num_clients", meta.get("num_clients", 1))
        partition = kwargs.pop("partition", None)
        if method == "distgat" and partition is None and "beta" in meta:
            partition = dirichlet_partition(
                graph.labels, num_clients, meta["beta"], meta.get("seed", 0)
            )
        return cls(
            bundle.params, bundle.model, graph,
            method=method, num_clients=num_clients, partition=partition,
            privacy=bundle.privacy, meta=meta, device=dev, **kwargs,
        )

    # -- graph / visibility plumbing ---------------------------------------

    def _set_graph(self, graph: Graph) -> None:
        self.graph = graph
        self._h, self._idx, self._mask = graph_tensors(graph, self.device)
        self._version += 1
        self._logits_memo.clear()
        self._vis_memo.clear()

    def _visible(self, client: int) -> Tuple[np.ndarray, torch.Tensor]:
        """(N, B) bool edge-visibility for ``client`` on the current graph,
        on the host and on the device."""
        vis = self._vis_memo.get(client)
        if vis is None:
            if self.method == "distgat":
                host = client_neighbor_masks(self.graph, self.part, clients=[client])[0]
                vis = (host, torch.as_tensor(host, device=self.device))
            else:
                vis = (self.graph.nbr_mask, self._mask)
            self._vis_memo[client] = vis
        return vis

    def _coverage_mask(self, client: int) -> Optional[np.ndarray]:
        """The visibility mask coverage and drift are measured under:
        the client's own under distgat, the full graph's otherwise."""
        return self._visible(client)[0] if self.method == "distgat" else None

    def _client_gen(self, client: int) -> torch.Generator:
        """The client's pack generator, fresh: every build under it draws
        the same stream."""
        return generator(_key_int(client_pack_key(self.pack_seed, client)), self.device)

    def _fingerprint(self, client: int) -> str:
        # Content-addressed on the CSR arrays: nbr_idx/nbr_mask derive
        # deterministically from (indptr, indices), so hashing the CSR pair
        # covers them at O(E) bytes instead of O(N * B).
        return graph_fingerprint(
            self.graph.features, self.graph.indptr, self.graph.indices,
            self._visible(client)[0],
            client_pack_key(self.pack_seed, client),
            extra=(self.cfg.engine, self.cfg.degree, self.cfg.basis,
                   self.cfg.domain, self.cfg.r),
        )

    # -- pack lifecycle -----------------------------------------------------

    def _build_pack(self, client: int) -> Any:
        """A from-scratch pack for ``client`` on the current graph (None for
        pack-free engines)."""
        if not self.engine.needs_pack:
            return None
        with torch.no_grad():
            return self.engine.precompute(
                self._client_gen(client), self._h, self._idx, self._visible(client)[1]
            )

    def _ensure_client(self, client: int) -> PackEntry:
        """The client's cache entry, building the pack on a miss."""
        if not (0 <= client < self.num_clients):
            raise ValueError(
                f"client {client} out of range [0, {self.num_clients})"
            )
        fp = self._fingerprint(client)
        entry = self.cache.get(client, fp)
        if entry is not None:
            return entry
        with telemetry.span("serving.pack_build", client=client):
            pack = self._build_pack(client)
        entry = PackEntry(pack=pack, fingerprint=fp)
        self.cache.put(client, entry)
        st = self._clients.setdefault(client, ClientState())
        st.covered = (
            initial_coverage(self.graph, self._coverage_mask(client))
            if self.engine.needs_pack else None
        )
        st.b_pack = self.graph.max_degree
        st.eps = 0.0
        return entry

    def pack_for(self, client: int) -> Any:
        """The client's current (cached / patched / refreshed) pack."""
        return self._ensure_client(client).pack

    def refresh(self, client: int) -> None:
        """Force a full pack rebuild for ``client`` — bit-identical to a
        from-scratch precompute on the current graph under the client's
        deterministic pack generator on the same device. Resets the
        tracked drift."""
        self._ensure_client(client)
        st = self._clients.setdefault(client, ClientState())
        pack = self._build_pack(client)
        if pack is not None:
            st.covered = initial_coverage(self.graph, self._coverage_mask(client))
        st.b_pack = self.graph.max_degree
        st.eps = 0.0
        st.refreshes += 1
        self.cache.note_refresh(client, self._fingerprint(client), pack)
        self._logits_memo.pop(client, None)

    # -- incremental updates ------------------------------------------------

    def apply_update(self, delta: GraphDelta) -> Dict[str, Any]:
        """Absorb a graph delta: patch every resident client pack locally,
        re-measure the Thm 3.5 drift, refresh any client whose bound
        crossed ``refresh_threshold``. Returns an update report."""
        if self.method == "distgat" and delta.num_new_nodes:
            if delta.owners is None:
                raise ValueError(
                    "distgat serving needs delta.owners: new nodes must be "
                    "assigned to a client for edge visibility"
                )
            owners = np.asarray(delta.owners, np.int32).reshape(-1)
            if owners.shape[0] != delta.num_new_nodes:
                raise ValueError("delta.owners length must match new node count")
            if owners.min() < 0 or owners.max() >= self.num_clients:
                raise ValueError("delta.owners out of client range")
            self.part = Partition(
                owner=np.concatenate([self.part.owner, owners]),
                num_clients=self.part.num_clients,
                beta=self.part.beta,
            )
        old_nodes = self.graph.num_nodes
        self._set_graph(apply_delta(self.graph, delta))
        refreshed: List[int] = []
        drift: Dict[int, float] = {}
        with telemetry.span(
            "serving.apply_update",
            new_nodes=delta.num_new_nodes, new_edges=delta.num_new_edges,
        ):
            for client in sorted(self._clients):
                st = self._clients[client]
                entry = self.cache.peek(client)
                if entry is None:              # evicted: rebuilt on next query
                    del self._clients[client]
                    continue
                if self.engine.needs_pack:
                    vis = self._coverage_mask(client)
                    patch_gen = generator(fold_in(
                        _key_int(client_pack_key(self.pack_seed, client)),
                        PATCH_STREAM + self._version,
                    ), self.device)
                    pack = patch_pack(
                        self.engine, patch_gen, entry.pack, old_nodes,
                        self.graph, st.b_pack, vis,
                    )
                    st.covered = extend_coverage(st.covered, self.graph, st.b_pack, vis)
                    st.eps = mass_drift(
                        self.params[0], self.coeffs, self.cfg.basis, self.cfg.domain,
                        self.graph, st.covered, vis,
                    )
                    st.patches += 1
                    st.history.append(st.eps)
                    self.cache.note_patch(client, self._fingerprint(client), pack)
                    drift[client] = st.eps
                    if self.drift(client)["bound"] > self.refresh_threshold:
                        self.refresh(client)
                        refreshed.append(client)
                else:
                    # Pack-free engines re-read the graph arrays: exact, no drift.
                    self.cache.revalidate(client, self._fingerprint(client))
                    st.history.append(0.0)
                    drift[client] = 0.0
        return {
            "new_nodes": delta.num_new_nodes,
            "new_edges": delta.num_new_edges,
            "num_nodes": self.graph.num_nodes,
            "drift": drift,
            "refreshed": refreshed,
        }

    def drift(self, client: int) -> Dict[str, Any]:
        """Tracked Thm 3.5 drift for a client's pack: measured eps, the
        propagated logit bound, and refresh accounting."""
        st = self._clients.get(client, ClientState())
        return {
            "eps": st.eps,
            "bound": thm35_logit_bound(st.eps, self.cfg.num_layers, self.cfg.heads),
            "threshold": self.refresh_threshold,
            "patches": st.patches,
            "refreshes": st.refreshes,
            "history": list(st.history),
        }

    # -- query path ---------------------------------------------------------

    def _client_logits(self, client: int) -> np.ndarray:
        memo = self._logits_memo.get(client)
        if memo is not None and memo[0] == self._version:
            self.cache.touch(client)
            return memo[1]
        entry = self._ensure_client(client)
        vis = self._visible(client)[1]
        with telemetry.span("serving.client_forward", client=client), torch.inference_mode():
            out = layered_forward(
                self.engine, self.params, self.coeffs, entry.pack,
                self._h, self._idx, vis,
            )
            # The host copy waits for the device: the forward's GPU time
            # lands inside the caller's timed region.
            logits = out.cpu().numpy()
        self._logits_memo[client] = (self._version, logits)
        return logits

    def serve_batch(self, queries: Sequence[Query]) -> List[QueryResult]:
        """Answer a microbatch: one forward per distinct client, per-query
        logits/labels gathered from it (input order preserved)."""
        by_client: Dict[int, List[int]] = {}
        for i, q in enumerate(queries):
            if not (0 <= q.node < self.graph.num_nodes):
                raise ValueError(
                    f"node {q.node} out of range [0, {self.graph.num_nodes})"
                )
            by_client.setdefault(int(q.client), []).append(i)
        out: List[Optional[QueryResult]] = [None] * len(queries)
        with telemetry.span(
            "serving.serve_batch", queries=len(queries), clients=len(by_client)
        ):
            for client, idxs in by_client.items():
                logits = self._client_logits(client)
                for i in idxs:
                    row = logits[queries[i].node]
                    out[i] = QueryResult(
                        client=client, node=int(queries[i].node),
                        logits=row, label=int(np.argmax(row)),
                    )
        telemetry.counter("serving.queries").inc(len(queries))
        return out  # type: ignore[return-value]

    # -- persistence --------------------------------------------------------

    def save_cache(self, directory: Optional[str] = None) -> Dict[str, Any]:
        """Persist the pack cache (entries + counters) so a restarted server
        warm-starts instead of re-precomputing every pack. Writes to
        ``directory`` or the ``cache_dir`` the server was built with."""
        target = directory or self.cache_dir
        if target is None:
            raise ValueError(
                "no cache directory: pass save_cache(directory=...) or "
                "construct the server with cache_dir="
            )
        return self.cache.save(target)

    # -- reporting ----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "engine": self.cfg.engine,
            "engine_fallback": self.engine_fallback,
            "method": self.method,
            "num_clients": self.num_clients,
            "num_nodes": self.graph.num_nodes,
            "graph_version": self._version,
            "device": str(self.device),
            "cache": self.cache.stats(),
            "drift": {c: self.drift(c) for c in sorted(self._clients)},
        }
