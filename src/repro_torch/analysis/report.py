"""Roofline report generator (the port of ``repro/analysis/report.py``):
reads dry-run JSON records and prints the roofline markdown table.

  PYTHONPATH=src python -m repro_torch.analysis.report [--dir build/dryrun]

The port's records carry no collective term and no HLO flop count (they
need XLA's compiled program); their columns print ``-``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

DEFAULT_DIR = "build/dryrun"


def load_records(dirpath: str, mesh: str = "16x16") -> List[Dict]:
    recs = []
    for p in sorted(pathlib.Path(dirpath).glob(f"*__{mesh}.json")):
        recs.append(json.loads(p.read_text()))
    return recs


def _fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def roofline_table(recs: List[Dict]) -> str:
    lines = [
        "| arch | shape | T_compute | T_memory | T_collective | bottleneck | "
        "MODEL_FLOPs/HLO_FLOPs | note |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r.get("status") != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | FAILED | — | {r.get('error','')} |")
            continue
        rl = r["roofline"]
        ratio = r.get("useful_flops_ratio")
        note = _note(r)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {_fmt_s(rl['compute_s'])} | "
            f"{_fmt_s(rl['memory_s'])} | {_fmt_s(rl.get('collective_s'))} | "
            f"**{rl['bottleneck']}** | {'-' if ratio is None else f'{ratio:.2f}'} | {note} |"
        )
    return "\n".join(lines)


def _note(r: Dict) -> str:
    """One sentence: what would move the dominant term down."""
    rl = r["roofline"]
    bk = rl["bottleneck"]
    coll = r.get("hlo_cost", {}).get("collective_by_kind", {})
    if bk == "collective":
        top = max(coll, key=coll.get) if coll else "?"
        return (f"dominant {top}; reduce by resharding to cut per-layer "
                f"{top} volume or overlapping with compute")
    if bk == "memory":
        return "weight/cache streaming bound; larger per-chip batch or better fusion raises intensity"
    return "compute-bound; higher arithmetic-intensity tiling or lower precision is the only lever"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    recs = load_records(args.dir, args.mesh)
    print(f"### Roofline — mesh {args.mesh} ({len(recs)} records)\n")
    print(roofline_table(recs))


if __name__ == "__main__":
    main()
