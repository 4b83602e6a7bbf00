"""The harness finds every configuration, cell, traffic runner, counter
and per-layer reader from its file, by the names in BENCHMARK.json."""
import json
from pathlib import Path

import pytest

from bench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
# the privacy cell reports its round under a bound of its own
ROUND = {"train.arxiv.kernel": "train_round_s", "train.arxiv.vector": "train_round_s",
         "train.arxiv.kernel.cohort-dp": "train_round_s.private"}


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
        # a call of many rounds, as a deployment runs (FederatedConfig's 60);
        # the warm call stays one round
        assert 2 <= int(cell.settings["rounds_per_call"]) <= 60
        assert {m["name"] for m in cell.end_to_end} == {
            ROUND[cell.name], "train_peak_gib", "setup_s"}
        spec.counts(f"fedgat_{cell.config['model']['engine']}")


def test_every_per_layer_metric_has_a_reader_and_its_cells_exist():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
        assert set(m.get("workloads", cells)) <= cells
        # every cell it lists reports the end-to-end metric it moves
        for name in m.get("workloads", cells):
            assert m["moves"] in {e["name"] for e in spec.load_cell(name).end_to_end}, (m, name)


def test_a_metric_listed_for_some_cells_reaches_only_those():
    cell = spec.load_cell("train.arxiv.vector")
    names = {m["name"] for m in cell.per_layer}
    assert "cheb_attn_fwd_roofline" not in names and "cohort_host_ms" not in names
    assert {"nbr_gather_bwd_ms", "train_mfu", "device_idle_pct"} <= names
    # the privacy cell reports its round under a bound of its own, and the
    # per-layer metrics that move it under the same split name
    cell = spec.load_cell("train.arxiv.kernel.cohort-dp")
    assert {m["name"] for m in cell.end_to_end} == {
        "train_round_s.private", "train_peak_gib", "setup_s"}
    assert {m["moves"] for m in cell.per_layer} == {"train_round_s.private"}
    assert {"nbr_gather_bwd_ms.private", "train_mfu.private", "cohort_host_ms"} <= {
        m["name"] for m in cell.per_layer}


@pytest.mark.parametrize("name,base", [("train_mfu.private", "train_mfu"),
                                       ("train_round_s.private", "train_round_s"),
                                       ("train_mfu", "train_mfu")])
def test_a_split_metric_names_its_base(name, base):
    assert spec.base_name(name) == base


def test_a_split_per_layer_metric_is_read_by_its_base_reader():
    from types import SimpleNamespace

    ctx = SimpleNamespace(round_flops=67e10, train_round_s=2.0)
    assert spec.metric_reader("train_mfu.private")(ctx) == spec.metric_reader("train_mfu")(ctx)
    assert spec.metric_reader("train_mfu.private")(ctx) == 0.5


def test_configuration_files_state_sources_assumptions_and_cuts():
    b = bench()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"] and cfg["graph"]["num_nodes"] == 169343
        assert cfg["graph"]["feature_dim"] == 128 and cfg["model"]["hidden"] == 8
