"""Serving launcher for the port — two modes, as ``repro/launch/serve.py``:

  lm     — batched prefill + decode over the language-model zoo (the
           default mode, as in the reference):
           python -m repro_torch.launch.serve --arch yi-6b --reduced \
               --batch 2 --prompt-len 16 --gen-len 8
  graph  — federated graph inference:

    python -m repro_torch.launch.serve --mode graph --ckpt BUNDLE_DIR --engine kernel
    python -m repro_torch.launch.serve --mode graph --clients 4 --rounds 20
    python -m repro_torch.launch.serve --mode graph --method distgat --fast --device cpu

Loads a serving bundle (written by either package's ``save_bundle``) or,
without ``--ckpt``, quick-trains one with the port's federated Trainer on
``FedGATConfig()`` (the paper's ``matrix`` engine), as the reference does;
then serves a seeded Poisson query stream through the microbatching
scheduler, absorbs a graph delta (patching every resident client's pack
and refreshing those whose Thm 3.5 bound crosses ``--refresh-threshold``)
and reports latency, drift and cache accounting. ``--engine`` overrides
the serving engine only. In both modes ``--device cpu`` runs (and trains
and serves) through the plain PyTorch versions; the
default is the CUDA device. ``--telemetry-dir DIR`` records spans and
events and writes the run's artifacts (trace, metrics, manifest, events)
to DIR.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

import numpy as np
import torch


def serve_lm(model, params, batch: Dict[str, torch.Tensor], gen_len: int, cache_len: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
    """Prefill ``batch`` then generate ``gen_len`` tokens a sequence: the
    first from the prefill's logits, then ``gen_len - 1`` decode steps,
    greedy or sampled at ``temperature`` from ``generator``. Returns the
    tokens (B, gen_len), the prefill's last-position logits, the final
    cache and the prefill and decode seconds (device work included)."""
    from repro_torch._device import sync

    vocab = model.cfg.vocab_size
    dev = batch["tokens"].device
    sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = model.prefill(params, dict(batch, cache_len=cache_len))
    sync(dev)
    prefill_s = time.perf_counter() - t0
    prefill_logits = logits
    tok = torch.argmax(logits[:, -1, :vocab], dim=-1)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(gen_len - 1):
            logits, cache = model.decode_step(params, cache, tok)
            lg = logits[:, -1, :vocab]
            if temperature > 0:
                probs = torch.softmax(lg / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)
            else:
                tok = torch.argmax(lg, dim=-1)[:, None]
            generated.append(tok)
    sync(dev)
    return {"tokens": torch.cat(generated, dim=1), "prefill_logits": prefill_logits, "cache": cache,
            "prefill_s": prefill_s, "decode_s": time.perf_counter() - t0}


def run_lm(argv=None) -> None:
    ap = argparse.ArgumentParser(description="LM serving (prefill + decode)")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch._device import resolve_device
    from repro_torch._rng import fold_in, generator
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    # Independent streams per consumer: one stream across init and the
    # synthetic inputs would correlate weights with data.
    g_params, g_prompt, g_prefix, g_frames, g_sample = (
        generator(fold_in(args.seed, i), dev) for i in range(5))
    params = model.init(g_params, dev)
    B = args.batch
    cache_len = args.prompt_len + args.gen_len + 8
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, args.prompt_len),
                                     generator=g_prompt, device=dev)}
    if cfg.family == "vlm":
        batch["prefix"] = torch.randn((B, cfg.prefix_len, cfg.d_model),
                                      generator=g_prefix, device=dev)
    if cfg.is_encdec:
        batch["frames"] = torch.randn(
            (B, max(args.prompt_len // cfg.encoder_ratio, 2), cfg.d_model),
            generator=g_frames, device=dev)

    res = serve_lm(model, params, batch, args.gen_len, cache_len,
                   temperature=args.temperature, generator=g_sample)
    print(f"prefill: {args.prompt_len} tokens x {B} in {res['prefill_s']:.2f}s (device {dev})")
    steps, dt = args.gen_len - 1, res["decode_s"]
    print(f"decode: {steps} steps x {B} seqs in {dt:.2f}s "
          f"({steps * B / max(dt, 1e-9):.1f} tok/s)")
    print("generated token ids:\n", res["tokens"].cpu().numpy())


def run_graph(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="federated graph inference (repro_torch.serving)"
    )
    ap.add_argument("--dataset", default="cora_like",
                    help="make_cora_like or make_sbm preset")
    ap.add_argument("--ckpt", default="",
                    help="serving bundle directory (default: quick-train one)")
    ap.add_argument("--method", default="fedgat", choices=["fedgat", "distgat"])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=20,
                    help="quick-train rounds (without --ckpt)")
    ap.add_argument("--engine", default=None,
                    choices=["matrix", "vector", "direct", "kernel", "exact"],
                    help="serving engine override (default: the checkpoint's)")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--qps", type=float, default=2000.0,
                    help="mean arrival rate of the synthetic query stream")
    ap.add_argument("--max-batch-size", type=int, default=32)
    ap.add_argument("--max-wait", type=float, default=0.005,
                    help="scheduler deadline (seconds)")
    ap.add_argument("--refresh-threshold", type=float, default=2.0,
                    help="Thm 3.5 logit bound that triggers a pack refresh")
    ap.add_argument("--update-nodes", type=int, default=8,
                    help="new nodes in the demo graph delta (0 = skip)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fast", action="store_true", help="smoke-size run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--telemetry-dir", default="",
                    help="enable repro_torch.telemetry and write the run artifacts "
                    "(trace.json/metrics.json/manifest.json/events.jsonl) here")
    args = ap.parse_args(argv)
    from repro_torch import telemetry

    if args.telemetry_dir:
        telemetry.enable(args.telemetry_dir)
    if args.fast:
        args.dataset = "tiny"
        args.clients = min(args.clients, 2)
        args.rounds = min(args.rounds, 2)
        args.queries = min(args.queries, 48)
        args.update_nodes = min(args.update_nodes, 4)

    from repro_torch.graphs import SBM_PRESETS, make_cora_like, make_sbm
    from repro_torch.serving import GraphDelta, GraphInferenceServer, MicroBatcher, Query

    make = make_sbm if args.dataset in SBM_PRESETS else make_cora_like
    g = make(args.dataset, seed=args.seed)
    ckpt_dir = args.ckpt
    if not ckpt_dir:
        import tempfile

        from repro_torch.core import FedGATConfig
        from repro_torch.federated import FederatedConfig, Trainer
        from repro_torch.federated.trainer import method_model_config
        from repro_torch.serving import save_bundle

        cfg = FederatedConfig(
            method=args.method, num_clients=args.clients, rounds=args.rounds,
            seed=args.seed, model=FedGATConfig(),
        )
        t0 = time.time()
        res = Trainer(cfg, device=args.device).run(g)
        print(f"trained: method={args.method} engine={method_model_config(cfg).engine} "
              f"rounds={args.rounds} best_test={res['best_test']:.4f} "
              f"in {time.time() - t0:.1f}s")
        ckpt_dir = tempfile.mkdtemp(prefix="fedgat_serve_")
        save_bundle(ckpt_dir, res["params"], cfg, step=args.rounds)
    server = GraphInferenceServer.from_checkpoint(
        ckpt_dir, g, engine=args.engine, refresh_threshold=args.refresh_threshold,
        device=args.device,
    )
    print(f"serving: engine={server.cfg.engine} method={server.method} "
          f"clients={server.num_clients} nodes={g.num_nodes} device={server.device}")

    rng = np.random.default_rng(args.seed)
    queries = [
        Query(int(c), int(n))
        for c, n in zip(
            rng.integers(0, server.num_clients, size=args.queries),
            rng.integers(0, g.num_nodes, size=args.queries),
        )
    ]
    arrivals = np.cumsum(rng.exponential(1.0 / args.qps, size=args.queries))
    batcher = MicroBatcher(
        server.serve_batch,
        max_batch_size=args.max_batch_size, max_wait=args.max_wait,
    )
    t0 = time.perf_counter()
    results = batcher.run(queries, arrivals.tolist())
    wall = time.perf_counter() - t0
    correct = sum(r.label == int(g.labels[r.node]) for r in results)
    s = batcher.stats.summary()
    print(f"served: {args.queries} queries in {int(s['batches'])} batches "
          f"(mean {s['mean_batch']:.1f}/batch) "
          f"p50={s['p50_ms']:.2f}ms p99={s['p99_ms']:.2f}ms "
          f"throughput={s['throughput_qps']:.0f} qps wall={wall:.3f}s "
          f"label_match={correct / max(len(results), 1):.3f}")

    if args.update_nodes:
        m = args.update_nodes
        feats = g.features[rng.integers(0, g.num_nodes, size=m)]
        feats = feats + 0.01 * rng.standard_normal(feats.shape).astype(np.float32)
        n_new = g.num_nodes + m
        edges = np.stack([
            np.arange(g.num_nodes, n_new),
            rng.integers(0, g.num_nodes, size=m),
        ], axis=1)
        owners = (
            rng.integers(0, server.num_clients, size=m)
            if server.method == "distgat" else None
        )
        report = server.apply_update(
            GraphDelta(features=feats, edges=edges, owners=owners)
        )
        worst = max(report["drift"].values(), default=0.0)
        print(f"delta: +{report['new_nodes']} nodes +{report['new_edges']} edges "
              f"-> {report['num_nodes']} nodes; worst_eps={worst:.4f} "
              f"refreshed={report['refreshed']}")
        post = server.serve_batch(
            [Query(0, int(n)) for n in range(g.num_nodes, n_new)]
        )
        print(f"post-update: served {len(post)} new-node queries")

    c = server.stats()["cache"]
    print(f"cache: entries={c['entries']} hits={c['hits']} misses={c['misses']} "
          f"patches={c['patches']} refreshes={c['refreshes']}")
    if args.telemetry_dir:
        paths = telemetry.write_run(args.telemetry_dir)
        print(f"telemetry: {len(telemetry.records())} spans -> {paths['trace']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--mode", choices=("lm", "graph"), default="lm")
    args, rest = ap.parse_known_args(argv)
    (run_graph if args.mode == "graph" else run_lm)(rest)


if __name__ == "__main__":
    main()
