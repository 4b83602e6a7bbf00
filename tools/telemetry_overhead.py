"""What telemetry costs the telemetry smoke's training run, and how much its
timings spread without it.

    python3 tools/telemetry_overhead.py [--pairs 4] [--device cuda]

Runs ``benchmarks_torch/telemetry_smoke.py``'s config (fedgat, ``direct``,
10 clients, 25 rounds of 3 local steps, cohorts of 4, on ``cora_like``)
once to warm up, then ``--pairs`` pairs of a run with telemetry off and one
with it on, alternating which goes first, and prints every run's wall
and process CPU seconds, each pair's overhead in both, and the spread of
the off runs among themselves (max / min - 1); ``--steady`` collects
garbage before each run and keeps the collector off during it, to show
how much of that spread the collector makes. Then it prints the spans'
own share of a run: the spans one enabled run records times the smoke's
``span_seconds``, the cost the smoke gates.
"""
from __future__ import annotations

import argparse
import gc
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from benchmarks_torch.telemetry_smoke import _run_once, span_seconds  # noqa: E402
from repro_torch import telemetry  # noqa: E402
from repro_torch._device import resolve_device  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="telemetry overhead of the smoke's run")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steady", action="store_true",
                    help="collect garbage before each run and keep the collector off "
                    "during it")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    telemetry.disable()
    _run_once(dev)                                          # warm-up
    times = {"off": [], "on": []}
    cpu = {"off": [], "on": []}
    overheads = []
    spans = 0
    for p in range(args.pairs):
        pair, pair_cpu = {}, {}
        for mode in (("off", "on") if p % 2 == 0 else ("on", "off")):
            telemetry.reset()
            (telemetry.enable if mode == "on" else telemetry.disable)()
            if args.steady:
                gc.collect()
                gc.disable()
            c0 = time.process_time()
            pair[mode] = _run_once(dev)[1]
            pair_cpu[mode] = time.process_time() - c0
            gc.enable()
            if mode == "on":
                spans = len(telemetry.records())
            telemetry.disable()
            times[mode].append(pair[mode])
            cpu[mode].append(pair_cpu[mode])
        overheads.append(pair["on"] / pair["off"] - 1)
        print(f"pair {p}: off {pair['off']:.3f} s (cpu {pair_cpu['off']:.3f}), on "
              f"{pair['on']:.3f} s (cpu {pair_cpu['on']:.3f}), overhead "
              f"{100 * overheads[-1]:+.2f}% (cpu "
              f"{100 * (pair_cpu['on'] / pair_cpu['off'] - 1):+.2f}%)", flush=True)
    off, off_cpu = times["off"], cpu["off"]
    print(f"off runs: median {statistics.median(off):.3f} s, spread (max/min - 1) "
          f"{100 * (max(off) / min(off) - 1):.2f}% "
          f"(cpu {100 * (max(off_cpu) / min(off_cpu) - 1):.2f}%); "
          f"on runs: median {statistics.median(times['on']):.3f} s; median pair overhead "
          f"{100 * statistics.median(overheads):+.2f}%; sums on/off - 1: wall "
          f"{100 * (sum(times['on']) / sum(off) - 1):+.2f}%, cpu "
          f"{100 * (sum(cpu['on']) / sum(off_cpu) - 1):+.2f}%", flush=True)

    per_span = span_seconds(100_000)
    share = spans * per_span / statistics.median(off)
    print(f"one empty device span: {per_span * 1e6:.2f} us on less off; {spans} spans a run "
          f"-> {spans * per_span * 1e3:.3f} ms, {100 * share:.4f}% of a run", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
