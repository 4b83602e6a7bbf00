"""Finds everything a run needs by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix;
each lives in files of its own, and so does each per-layer metric:

- ``bench/configs/<config>.json``: the configuration as it is run (the
  ``file`` that ``BENCHMARK.json`` gives it);
- ``bench/traffic/<traffic>.json``: the traffic mix, a data file whose
  ``kind`` names its runner, ``bench/traffic/<kind>.py``;
- ``bench/workloads/<cell>.json``: what belongs to the cell alone;
- ``bench/metrics/<metric>.py``: a per-layer metric's reader, a function
  ``read(ctx)`` that returns a number or ``None`` when it finds nothing;
- ``bench/counts/<name>.py``: operation and byte counts.

So a later change adds a configuration, a cell or a metric as new files
and an entry in ``BENCHMARK.json``, and edits none.

A metric named ``<base>.<variant>`` is the quantity ``<base>`` in the cells
it lists, split off where those cells report another end-to-end metric
(say, with a bound of their own): the runner's ``<base>`` value, and the
reader ``bench/metrics/<base>.py`` unless ``<base>.<variant>.py`` exists.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file of the benchmark by its path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark file {path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with the files it names."""

    name: str
    chips: int
    config: dict         # bench/configs/<config>.json
    traffic: dict        # bench/traffic/<traffic>.json
    settings: dict       # bench/workloads/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def runner(self) -> ModuleType:
        return load_module(BENCH / "traffic" / f"{self.kind}.py", f"bench_traffic_{self.kind}")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[entry["config"]]["file"])
    traffic = _json(root / "bench" / "traffic" / f"{entry['traffic']}.json")
    settings = _json(root / "bench" / "workloads" / f"{name}.json")
    return Cell(
        name=name, chips=int(entry["chips"]), config=config, traffic=traffic,
        settings=settings,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def base_name(name: str) -> str:
    """``<base>`` of a metric named ``<base>.<variant>``; else the name."""
    return name.rsplit(".", 1)[0] if "." in name else name


def metric_reader(name: str):
    """The ``read(ctx)`` of ``bench/metrics/<name>.py``, or of its base's."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file():
        name = base_name(name)
        path = BENCH / "metrics" / f"{name}.py"
    return load_module(path, f"bench_metric_{name}").read


def counts(name: str) -> ModuleType:
    """``bench/counts/<name>.py``, as the package module ``bench.counts.<name>``."""
    return importlib.import_module(f"bench.counts.{name}")

