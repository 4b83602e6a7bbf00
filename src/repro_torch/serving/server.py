"""GraphInferenceServer — online node classification over a trained FedGAT.

The port of ``repro/serving/server.py`` for ``method="fedgat"`` and the
pack-free engines (``direct``, ``kernel``, ``exact``). The unit of work is
one layered forward per (client, graph version): a microbatch's queries are
grouped by client, each distinct client costs one forward (through the
fused CUDA ``cheb_attn`` kernel under ``engine="kernel"``), and per-query
logits are gathered from it. Graph deltas are absorbed exactly: the engines
re-read the graph arrays, so an update only revalidates the cache.

Unlike the reference, the server never substitutes one engine for another:
``engine="kernel"`` on the GPU launches the kernel or raises, and
``stats()["engine_fallback"]`` is always ``None``.
"""
from __future__ import annotations

import copy
from dataclasses import replace
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import telemetry
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.engine import get_engine
from repro_torch.core.fedgat_model import FedGATConfig, graph_tensors, layered_forward
from repro_torch.graphs.graph import Graph
from repro_torch.serving.cache import PackCache, PackEntry, graph_fingerprint
from repro_torch.serving.checkpoint import load_bundle
from repro_torch.serving.updates import GraphDelta, apply_delta

SERVABLE_METHODS = ("fedgat",)
_MASK64 = (1 << 64) - 1


class Query(NamedTuple):
    client: int
    node: int


class QueryResult(NamedTuple):
    client: int
    node: int
    logits: np.ndarray      # (C,)
    label: int              # argmax class


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def client_pack_key(seed: int, client: int) -> np.ndarray:
    """Deterministic per-client pack key, as two uint32 words.

    The reference folds the client into a JAX PRNG key
    (``jax.random.fold_in``); the port hashes ``(seed, client)`` with
    splitmix64 instead, so the two packages' keys differ. Under the
    pack-free engines the key only feeds the cache fingerprint, so served
    logits and cache hits and misses are the same either way.
    """
    z = _splitmix64(_splitmix64(int(seed) & _MASK64) ^ (int(client) & _MASK64))
    return np.array([z >> 32, z & 0xFFFFFFFF], dtype=np.uint32)


class GraphInferenceServer:
    """Serve node-classification queries from a trained FedGAT checkpoint.

    Typical use::

        server = GraphInferenceServer.from_checkpoint("ckpt/", graph,
                                                      engine="kernel")
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
        engine: Optional[str] = None,
        pack_seed: int = 0,
        cache: Optional[PackCache] = None,
        privacy: Optional[Dict[str, Any]] = None,
        meta: Optional[Dict[str, Any]] = None,
        device: DeviceLike = None,
    ):
        if method not in SERVABLE_METHODS:
            raise ValueError(
                f"method {method!r} is not servable by this package; "
                f"supported: {SERVABLE_METHODS}"
            )
        if num_clients < 1:
            raise ValueError(f"num_clients must be >= 1, got {num_clients}")
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
        self.pack_seed = int(pack_seed)
        self.cache = cache if cache is not None else PackCache()
        self.privacy = dict(privacy or {})
        self.meta = dict(meta or {})
        self._history: Dict[int, List[float]] = {}   # resident clients' drift
        self._version = 0
        self._logits_memo: Dict[int, Tuple[int, np.ndarray]] = {}
        self._set_graph(graph)

    @classmethod
    def from_checkpoint(
        cls, path: str, graph: Graph, *, device: DeviceLike = None, **kwargs
    ) -> "GraphInferenceServer":
        """Load a bundle written by the reference's ``save_bundle`` and
        serve it. Method and num_clients come from the bundle; keyword
        overrides win."""
        dev = resolve_device(device)
        bundle = load_bundle(path, graph, device=dev)
        meta = bundle.meta
        method = kwargs.pop("method", meta.get("method", "fedgat"))
        num_clients = kwargs.pop("num_clients", meta.get("num_clients", 1))
        return cls(
            bundle.params, bundle.model, graph,
            method=method, num_clients=num_clients,
            privacy=bundle.privacy, meta=meta, device=dev, **kwargs,
        )

    def _set_graph(self, graph: Graph) -> None:
        self.graph = graph
        self._h, self._idx, self._mask = graph_tensors(graph, self.device)
        self._version += 1
        self._logits_memo.clear()

    def _fingerprint(self, client: int) -> str:
        # Content-addressed on the CSR arrays, from which nbr_idx/nbr_mask
        # derive; under method="fedgat" every client sees the full mask.
        return graph_fingerprint(
            self.graph.features, self.graph.indptr, self.graph.indices,
            self.graph.nbr_mask,
            client_pack_key(self.pack_seed, client),
            extra=(self.cfg.engine, self.cfg.degree, self.cfg.basis,
                   self.cfg.domain, self.cfg.r),
        )

    def _ensure_client(self, client: int) -> PackEntry:
        """The client's cache entry, created on a miss."""
        if not (0 <= client < self.num_clients):
            raise ValueError(
                f"client {client} out of range [0, {self.num_clients})"
            )
        fp = self._fingerprint(client)
        entry = self.cache.get(client, fp)
        if entry is not None:
            return entry
        entry = PackEntry(pack=None, fingerprint=fp)
        self.cache.put(client, entry)
        self._history.setdefault(client, [])
        return entry

    def apply_update(self, delta: GraphDelta) -> Dict[str, Any]:
        """Absorb a graph delta. The engines re-read the graph arrays, so
        the update is exact: resident entries are revalidated and the
        recorded drift is 0. Returns an update report."""
        self._set_graph(apply_delta(self.graph, delta))
        drift: Dict[int, float] = {}
        with telemetry.span(
            "serving.apply_update",
            new_nodes=delta.num_new_nodes, new_edges=delta.num_new_edges,
        ):
            for client in sorted(self._history):
                if self.cache.peek(client) is None:    # evicted: rebuilt on next query
                    del self._history[client]
                    continue
                self.cache.revalidate(client, self._fingerprint(client))
                self._history[client].append(0.0)
                drift[client] = 0.0
        return {
            "new_nodes": delta.num_new_nodes,
            "new_edges": delta.num_new_edges,
            "num_nodes": self.graph.num_nodes,
            "drift": drift,
            "refreshed": [],
        }

    def drift(self, client: int) -> Dict[str, Any]:
        """Drift of a client's view: exactly zero under pack-free engines."""
        return {"eps": 0.0, "bound": 0.0, "history": list(self._history.get(client, []))}

    def _client_logits(self, client: int) -> np.ndarray:
        memo = self._logits_memo.get(client)
        if memo is not None and memo[0] == self._version:
            self.cache.touch(client)
            return memo[1]
        self._ensure_client(client)
        with telemetry.span("serving.client_forward", client=client), torch.inference_mode():
            out = layered_forward(
                self.engine, self.params, self.coeffs, None,
                self._h, self._idx, self._mask,
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
            "drift": {c: self.drift(c) for c in sorted(self._history)},
        }
