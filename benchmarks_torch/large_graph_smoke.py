"""Smoke of the port: the 1e5-node path never touches an (N, N) array.

The port of ``benchmarks/large_graph_smoke.py``. Builds the ``sbm_100k``
preset (1e5 nodes, avg degree <= 16, degree-capped neighbour lists),
partitions it over 8 clients, extracts one client's local subgraph, runs
one flat kernel-engine layer forward (one ``cheb_attn`` launch on the
card) and one ``direct`` serving microbatch, then asserts

  * the lazy dense-adjacency view counter is still ZERO (nothing in the
    stack materialised an (N, N) array), and
  * peak RSS stayed under the budget (default 6 GiB, override with
    ``REPRO_SMOKE_RSS_MB``).

It prints the card's peak allocation (``torch.cuda.max_memory_allocated``)
beside the RSS. Not a benchmark module (no ``run``/``derived``): run it
directly,

  PYTHONPATH=src python benchmarks_torch/large_graph_smoke.py [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

if __package__ in (None, ""):
    _root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_root / "src"))
    sys.path.insert(0, str(_root))


def main(argv=None) -> None:
    from benchmarks_torch.common import peak_rss_mb

    ap = argparse.ArgumentParser(description="1e5-node smoke: no dense adjacency")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    budget_mb = float(os.environ.get("REPRO_SMOKE_RSS_MB", 6144))

    import torch

    from repro_torch._device import resolve_device
    from repro_torch.core import FedGATConfig
    from repro_torch.core.chebyshev import attention_series
    from repro_torch.core.fedgat_model import FedGAT, graph_tensors
    from repro_torch.federated.partition import (
        client_subgraph,
        cross_client_edge_count,
        dirichlet_partition,
    )
    from repro_torch.graphs import dense_view_count, make_sbm, reset_dense_view_count
    from repro_torch.kernels.ops import cheb_attn_layer
    from repro_torch.serving import GraphInferenceServer, Query

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_dense_view_count()

    t0 = time.perf_counter()
    g = make_sbm("sbm_100k", seed=0)
    print(f"build: {g.num_nodes} nodes, {g.num_undirected_edges()} edges, "
          f"avg deg {g.degrees().mean():.1f}, B={g.max_degree}, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    assert g.num_nodes == 100_000
    assert g.degrees().mean() <= 16.0

    t0 = time.perf_counter()
    part = dirichlet_partition(g.labels, 8, beta=1.0, seed=0)
    crossing = cross_client_edge_count(g, part)
    sub = client_subgraph(g, part, 0, hops=1)
    print(f"partition: K=8, {crossing} cross-client edges, client 0 local "
          f"subgraph {sub.graph.num_nodes} nodes ({sub.num_halo} halo), "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    assert 0 < crossing < g.num_undirected_edges()
    assert 0 < sub.graph.num_nodes < g.num_nodes

    # one flat kernel-engine layer forward over the full 1e5-node graph
    t0 = time.perf_counter()
    heads, d_out = 2, 8
    gen = torch.Generator().manual_seed(0)
    params = {
        "W": (torch.randn((heads, g.feature_dim, d_out), generator=gen) * 0.2).to(dev),
        "a1": (torch.randn((heads, d_out), generator=gen) * 0.2).to(dev),
        "a2": (torch.randn((heads, d_out), generator=gen) * 0.2).to(dev),
    }
    coeffs = torch.as_tensor(attention_series(4, (-4.0, 4.0)), dtype=torch.float32,
                             device=dev)
    with torch.no_grad():
        out = cheb_attn_layer(params, coeffs, *graph_tensors(g, dev)).cpu()
    assert out.shape == (g.num_nodes, heads * d_out)
    assert bool(torch.isfinite(out).all())
    print(f"kernel forward: {tuple(out.shape)}, {time.perf_counter() - t0:.1f}s",
          flush=True)

    # one serving microbatch through the inference server (pack-free
    # engine: the pack precompute is the O(N d g^2) cost this smoke skips)
    t0 = time.perf_counter()
    cfg = FedGATConfig(engine="direct", degree=4, heads=2, out_heads=1)
    srv_params = FedGAT(cfg, device=dev).init(torch.Generator().manual_seed(1), g)
    server = GraphInferenceServer(srv_params, cfg, g, num_clients=1, device=dev)
    results = server.serve_batch(
        [Query(client=0, node=int(n)) for n in (0, 17, 99_999)]
    )
    assert len(results) == 3
    assert all(0 <= r.label < g.num_classes for r in results)
    print(f"serving microbatch: {len(results)} queries, "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    views = dense_view_count()
    rss = peak_rss_mb()
    card = (f"{torch.cuda.max_memory_allocated(dev) / 2**20:.0f} MB" if on_card
            else "not measured (CPU run)")
    print(f"dense views: {views}, peak RSS: {rss:.0f} MB "
          f"(budget {budget_mb:.0f} MB), card peak allocated: {card}", flush=True)
    assert views == 0, f"a dense (N, N) adjacency was materialised ({views}x)"
    assert rss < budget_mb, f"peak RSS {rss:.0f} MB over budget {budget_mb:.0f} MB"
    print("LARGE_GRAPH_SMOKE_OK", flush=True)


if __name__ == "__main__":
    main()
