"""repro_torch.serving — federated graph inference on the GPU.

* :class:`GraphInferenceServer` — loads a bundle written by either package
  (params + ``FedGATConfig`` provenance) and answers batched queries per
  client through the layer-1 engine (the CUDA ``cheb_attn`` kernel under
  ``engine="kernel"``), for the ``fedgat`` and ``distgat`` methods;
* :class:`PackCache` — each client's one-shot pre-communicated pack, keyed
  by a graph-partition fingerprint, with hit/miss/patch/refresh accounting
  and persistence;
* :class:`GraphDelta` / :func:`apply_delta` — incremental graph updates:
  new nodes and edges are absorbed with a cheap local pack patch
  (:func:`patch_pack`), the accumulated approximation error
  (:func:`mass_drift`) is tracked against the paper's Thm 3.5 bound
  (``repro_torch.analysis.error_bounds``) and a full per-client pack
  refresh fires only when the bound is crossed;
* :class:`MicroBatcher` — size/deadline microbatching with p50/p99 latency
  and throughput accounting.
"""
from repro_torch.serving.cache import PackCache, PackEntry, graph_fingerprint
from repro_torch.serving.checkpoint import ServingCheckpoint, load_bundle, save_bundle
from repro_torch.serving.scheduler import LatencyStats, MicroBatcher
from repro_torch.serving.server import (
    GraphInferenceServer,
    Query,
    QueryResult,
    client_pack_key,
)
from repro_torch.serving.updates import (
    Coverage,
    GraphDelta,
    apply_delta,
    concat_pack_rows,
    coverage_lookup,
    extend_coverage,
    initial_coverage,
    mass_drift,
    patch_pack,
)

__all__ = [
    "Coverage",
    "GraphDelta",
    "GraphInferenceServer",
    "LatencyStats",
    "MicroBatcher",
    "PackCache",
    "PackEntry",
    "Query",
    "QueryResult",
    "ServingCheckpoint",
    "apply_delta",
    "client_pack_key",
    "concat_pack_rows",
    "coverage_lookup",
    "extend_coverage",
    "graph_fingerprint",
    "initial_coverage",
    "load_bundle",
    "mass_drift",
    "patch_pack",
    "save_bundle",
]
