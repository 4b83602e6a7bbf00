"""repro_torch.serving — federated graph inference on the GPU.

* :class:`GraphInferenceServer` — loads a bundle written by the reference
  (params + ``FedGATConfig`` provenance) and answers batched queries per
  client through the layer-1 engine (the CUDA ``cheb_attn`` kernel under
  ``engine="kernel"``);
* :class:`PackCache` — per-client cache validity and hit/miss accounting;
* :class:`GraphDelta` / :func:`apply_delta` — incremental graph updates;
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
from repro_torch.serving.updates import GraphDelta, apply_delta

__all__ = [
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
    "graph_fingerprint",
    "load_bundle",
    "save_bundle",
]
