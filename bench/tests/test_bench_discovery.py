"""The harness finds every configuration, cell, traffic runner, counter
and per-layer reader from its file, by the names in BENCHMARK.json."""
import json
from pathlib import Path

from bench.harness import spec

ROOT = Path(__file__).resolve().parents[2]


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_finds_its_files():
    b = bench()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["kind"] == "federated"
        assert hasattr(cell.runner(), "measure")
        assert set(cell.settings["limits"]) == {"loss", "grad1", "local", "round", "eval"}
        assert int(cell.settings["rounds_per_call"]) in (1, 2)
        assert {m["name"] for m in cell.end_to_end} == {
            "train_round_s", "train_peak_gib", "setup_s"}
        spec.counts(f"fedgat_{cell.config['model']['engine']}")


def test_every_per_layer_metric_has_a_reader_and_its_cells_exist():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_a_metric_listed_for_some_cells_reaches_only_those():
    cell = spec.load_cell("train.arxiv.vector")
    names = {m["name"] for m in cell.per_layer}
    assert "cheb_attn_fwd_roofline" not in names and "cohort_host_ms" not in names
    assert {"gather_bwd_ms", "train_mfu", "device_idle_pct"} <= names


def test_configuration_files_state_sources_assumptions_and_cuts():
    b = bench()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"] and cfg["graph"]["num_nodes"] == 169343
        assert cfg["graph"]["feature_dim"] == 128 and cfg["model"]["hidden"] == 8
