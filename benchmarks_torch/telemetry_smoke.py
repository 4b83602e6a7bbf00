"""Telemetry smoke of the port: overhead gate + trace/manifest validation.

The port of ``benchmarks/telemetry_smoke.py``. Runs one fig2-style
federated training config on the vmap backend — a warm-up (kernel library
loads, allocator growth), then ``REPEATS`` pairs of timed runs, one with
telemetry disabled and one with it enabled, the order alternating from
pair to pair (off, on, on, off, off, on, ...) — then asserts the
observability contract end to end:

* every enabled and disabled run is **bitwise identical** (telemetry is
  host-side instrumentation only; it must not move a single bit of the
  training computation);
* enabled-mode overhead is below the gate (default 5%;
  ``REPRO_TELEMETRY_MAX_OVERHEAD`` overrides — shared runners occasionally
  need slack). The gate holds what the instrumentation costs a run: the
  spans and events an enabled run records, times what one span costs to
  enter and leave with telemetry on less what it costs with it off
  (``SPAN_PROBES`` empty device spans a mode: on the card each records its
  pair of CUDA events, and each is resolved as ``records()`` does), over
  the median disabled run. The wall-clock
  overhead of ``REPEATS`` adjacent off/on pairs (order alternating; the
  median of each pair's enabled over disabled time) is printed beside it
  but not gated: this host-bound loop's identical runs drift by more than
  the gate between runs of one process;
* the Chrome trace of the last enabled run parses, and contains nested
  round -> cohort -> step spans (the config sets
  ``max_concurrent_clients`` so the cohort path runs), one round span per
  round;
* the manifest records the process's kernel builds under ``jit_compiles``
  (the port has no XLA compile counter: the value equals the number of
  CUDA libraries this process built, 0 when they were built before);
* the metrics snapshot carries the comm gauges.

Artifacts (trace.json / metrics.json / manifest.json / events.jsonl) are
written to ``--out`` (default ``telemetry_run/``).

  PYTHONPATH=src python benchmarks_torch/telemetry_smoke.py [--out DIR] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import statistics
import sys
import time

if __package__ in (None, ""):  # run as a script: wire repo root + src
    _root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(_root / "src"))
    sys.path.insert(0, str(_root))

ROUNDS = 25
REPEATS = 3           # timed off/on pairs
SPAN_PROBES = 20_000  # empty spans timed a mode


def _run_once(device):
    from repro_torch._device import sync
    from repro_torch.core import FedGATConfig
    from repro_torch.federated import FederatedConfig, Trainer
    from repro_torch.graphs import make_cora_like

    g = make_cora_like("cora_like", seed=0)
    cfg = FederatedConfig(
        method="fedgat", num_clients=10, rounds=ROUNDS, local_steps=3,
        lr=0.02, seed=0, max_concurrent_clients=4,
        model=FedGATConfig(engine="direct", degree=16),
    )
    t0 = time.perf_counter()
    res = Trainer(cfg, device=device).run(g)
    sync(device)
    return res, time.perf_counter() - t0, cfg


def span_seconds(n: int = SPAN_PROBES) -> float:
    """Seconds one empty device span costs to enter, leave and resolve
    with telemetry on (the dearest kind: on the card, a pair of CUDA events
    recorded and read back), less what it costs with telemetry off; leaves
    telemetry disabled and no span recorded."""
    from repro_torch import telemetry

    cost = {}
    for on in (True, False):
        telemetry.reset()
        (telemetry.enable if on else telemetry.disable)()
        t0 = time.perf_counter()
        for i in range(n):
            with telemetry.device_span("probe", i=i):
                pass
        telemetry.records()
        cost[on] = (time.perf_counter() - t0) / n
    telemetry.reset()
    return cost[True] - cost[False]


def main(argv=None) -> int:
    import torch

    from repro_torch import telemetry
    from repro_torch._device import resolve_device
    from repro_torch.kernels import _build

    ap = argparse.ArgumentParser(description="telemetry overhead smoke")
    ap.add_argument("--out", default="telemetry_run",
                    help="artifact directory (trace/metrics/manifest/events)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    max_overhead = float(os.environ.get("REPRO_TELEMETRY_MAX_OVERHEAD", "0.05"))
    dev = resolve_device(args.device)

    telemetry.disable()
    r_off, _, cfg = _run_once(dev)                # warm-up
    pairs = []
    for p in range(REPEATS):                      # off, on, on, off, off, on, ...
        seconds = {}
        for on in ((False, True), (True, False))[p % 2]:
            if on:
                telemetry.reset()                 # the trace keeps the last enabled run
            (telemetry.enable if on else telemetry.disable)()
            res, seconds[on], _ = _run_once(dev)
            # -- bitwise parity: every run equals the warm-up ----------------
            assert res["val_curve"] == r_off["val_curve"], "telemetry moved val_curve"
            assert res["test_curve"] == r_off["test_curve"], "telemetry moved test_curve"
            for a, b in zip(r_off["params"].parameters(), res["params"].parameters()):
                assert torch.equal(a, b), "telemetry moved the params"
        pairs.append((seconds[False], seconds[True]))
    recorded = len(telemetry.records()) + len(telemetry.events())
    paths = telemetry.write_run(args.out, cfg)
    telemetry.disable()

    # -- overhead gate -------------------------------------------------------
    per_span = span_seconds()
    t_off = statistics.median(t_off for t_off, _ in pairs)
    overhead = recorded * per_span / t_off
    wall = statistics.median(t_on / t_off - 1 for t_off, t_on in pairs)
    shown = [(round(t_off, 3), round(t_on, 3)) for t_off, t_on in pairs]
    print(f"telemetry_smoke: (disabled, enabled) s {shown}, wall-clock overhead "
          f"{wall * 100:+.2f}% (median of the pairs; not gated)")
    print(f"telemetry_smoke: {recorded} spans and events a run x {per_span * 1e6:.2f} us a "
          f"span = {recorded * per_span * 1e3:.3f} ms, overhead {overhead * 100:.3f}% of the "
          f"median disabled run (gate {max_overhead * 100:.0f}%)")
    if overhead > max_overhead:
        print(f"FAIL telemetry overhead {overhead * 100:.2f}% exceeds "
              f"{max_overhead * 100:.0f}% gate", file=sys.stderr)
        return 1

    # -- trace schema --------------------------------------------------------
    trace = json.loads(open(paths["trace"]).read())
    events = trace["traceEvents"]
    names = {e["name"] for e in events}
    for need in ("round", "cohort", "step", "evaluate"):
        assert need in names, f"trace missing {need!r} spans (have {sorted(names)})"
    cohort_parents = {e["args"].get("parent") for e in events if e["name"] == "cohort"}
    assert cohort_parents == {"round"}, cohort_parents
    step_parents = {e["args"].get("parent") for e in events if e["name"] == "step"}
    assert step_parents == {"cohort"}, step_parents
    rounds_seen = {e["args"]["round"] for e in events if e["name"] == "round"}
    assert len(rounds_seen) == ROUNDS, (
        f"expected {ROUNDS} round spans, saw {len(rounds_seen)}")

    # -- manifest + metrics --------------------------------------------------
    manifest = json.loads(open(paths["manifest"]).read())
    assert "jit_compiles" in manifest, sorted(manifest)
    assert manifest["jit_compiles"] == len(_build.build_info), manifest
    metrics = json.loads(open(paths["metrics"]).read())
    assert "comm.upload_scalars" in metrics, sorted(metrics)

    print(f"telemetry_smoke: OK — {len(events)} spans, "
          f"{manifest['jit_compiles']} kernel builds, artifacts in {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
