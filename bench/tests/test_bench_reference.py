"""The reference follows the program's CPU run of one round of each
cell's traffic at a small graph, and the harness's run of a cell comes
out correct on the CPU, every number far under its limit: the warm
call's, and the first round's of each window call of many rounds."""
import time

import pytest

from bench.harness import main

SEED = 2 ** 31 + 2024          # above 32 signed bits, as large seeds are
COHORT = "train.arxiv.kernel.cohort-dp"


def split(cell, name):
    """``name`` as the cell reports it: the privacy cell's round, and the
    per-layer metrics that move it, carry ``.private``."""
    return f"{name}.private" if cell.name == COHORT else name


def test_one_round_of_each_cell_matches_the_reference(tiny_cell):
    result = main.run_cell(tiny_cell, SEED, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    for name, c in result["checks"].items():
        assert c["value"] < c["limit"] / 10, (name, c)
    assert list(result)[-1] == "checks"
    e2e = result["metrics"]
    assert set(e2e) == {split(tiny_cell, "train_round_s"), "train_peak_gib", "setup_s"}
    assert e2e[split(tiny_cell, "train_round_s")]["value"] > 0
    window, limits = result["window"], tiny_cell.settings["limits"]
    assert window["judged"] == window["calls"] >= 1
    assert result["attempted"] == window["calls"] * tiny_cell.settings["rounds_per_call"]
    assert window["round_window"] < limits["round"] / 10, window
    assert window["eval_window"] < limits["eval"] / 10, window


def test_a_traced_run_reads_its_per_layer_metrics(tiny_cell):
    result = main.run_cell(tiny_cell, SEED + 1, 0.2, True, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    got = set(result["metrics"])
    assert got <= {m["name"] for m in tiny_cell.per_layer}
    assert {split(tiny_cell, "trainer_setup_ms"), split(tiny_cell, "train_mfu")} <= got
    # the CPU has no device trace: device readers find nothing and stay silent
    assert not {split(tiny_cell, "nbr_gather_bwd_ms"),
                split(tiny_cell, "cheb_attn_fwd_roofline")} & got
    if tiny_cell.traffic.get("max_concurrent_clients"):
        assert "cohort_host_ms" in got
    assert result["device"]["window_s"] > 0


def test_the_same_seed_gives_the_same_inputs(tiny_cell):
    import torch

    drv = tiny_cell.runner()
    a, b = drv.prepare(tiny_cell, SEED, "cpu"), drv.prepare(tiny_cell, SEED, "cpu")
    for key in a.graph:
        assert (a.graph[key] == b.graph[key]).all()
    for x, y in zip(drv.leaves(a.params0), drv.leaves(b.params0)):
        assert torch.equal(x, y)
    c = drv.prepare(tiny_cell, SEED + 7, "cpu")
    assert c.graph["features"].shape == a.graph["features"].shape
    assert not (c.graph["labels"] == a.graph["labels"]).all()


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 40 + 3])
def test_large_seeds_are_taken(seed):
    from bench.traffic import federated

    s = federated.derive_seeds(seed)
    assert all(0 <= v < 2 ** 63 for v in s.values()) and len(set(s.values())) == len(s)
