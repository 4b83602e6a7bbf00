"""The deep model's cell (``train.arxiv.gat4x256-skip.kernel``): the harness
finds its files, its runner drives the program end to end on the CPU at a
small graph (the configuration's widths kept) and comes out correct, the
planted faults (the skip dropped among them) come out not correct, and
its two span readers read made-up spans where what they must leave out is
known. On the card, the TF32 control and the skip dropped in the
reference come out not correct."""
import functools
import time
from types import SimpleNamespace

import pytest
import torch

from bench.harness import main, spec
from bench.harness.main import checks_of, is_correct
from conftest import cut_cell
from test_bench_faults import faulty

CELL = "train.arxiv.gat4x256-skip.kernel"
SEED = 2 ** 31 + 321
FAULTS = ["unchanged", "half_batch", "exchange", "answer", "one_leaf", "skip_dropped"]


@pytest.fixture
def deep_cell():
    torch.set_num_threads(1)
    return cut_cell(CELL)


def plant(monkeypatch, fault):
    from repro_torch.core import fedgat_model

    if fault == "skip_dropped":             # the skip's projection never added
        project = fedgat_model.skip_projection

        @functools.wraps(project)
        def dropped(P, x):
            return project(P, x) * 0.0      # P stays in the graph, its gradient 0
        monkeypatch.setattr(fedgat_model, "skip_projection", dropped)
        return
    for owner, name, fn in faulty(fault):
        monkeypatch.setattr(owner, name, fn)


def test_the_cell_finds_its_files():
    cell = spec.load_cell(CELL)
    assert cell.config["name"] == "gat4x256-skip-arxiv.kernel"
    model = cell.config["model"]
    assert (model["num_layers"], model["heads"], model["hidden"], model["out_heads"],
            model["skip"], model["engine"]) == (3, 4, 256, 6, True, "kernel")
    assert cell.kind == "federated_deep" and hasattr(cell.runner(), "measure")
    assert set(cell.settings["limits"]) == {"loss", "grad1", "local", "round", "eval"}
    assert int(cell.settings["rounds_per_call"]) >= 3
    assert {m["name"] for m in cell.end_to_end} == {"train_round_s", "train_peak_gib", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"exact_layers_fwd_ms", "skip_fwd_ms", "step_forward_ms", "nbr_gather_bwd_ms",
            "train_mfu", "device_idle_pct", "cheb_attn_fwd_roofline"} <= names
    for name in names:
        assert callable(spec.metric_reader(name))
    # the traffic is train.arxiv.kernel's but for the runner
    old = spec.load_cell("train.arxiv.kernel")
    assert {k: v for k, v in cell.traffic.items() if k not in ("kind", "why")} == {
        k: v for k, v in old.traffic.items() if k not in ("kind", "why")}
    assert cell.config["graph"] == old.config["graph"]
    # a two-layer model's forward opens neither span
    assert not {"skip_fwd_ms", "exact_layers_fwd_ms"} & {m["name"] for m in old.per_layer}


def test_the_counts_of_a_two_layer_model_are_the_kernel_engines():
    from bench.counts import fedgat_kernel, fedgat_kernel_skip

    old = spec.load_cell("train.arxiv.kernel").config
    args = (old["graph"], 32, 3, 2)
    assert fedgat_kernel_skip.round_flops(old["model"], *args) == fedgat_kernel.round_flops(
        old["model"], *args)
    deep = spec.load_cell(CELL).config
    # the skip adds two GEMMs a step beside layer 2's own (2 N 1024 1024 each way)
    no_skip = dict(deep["model"], skip=False)
    gemm = 2 * 169343 * 1024 * 1024
    step = fedgat_kernel_skip.step_and_eval
    n, b, d, c = 169343, 32, 128, 40
    assert step(deep["model"], n, b, d, c)[0] - step(no_skip, n, b, d, c)[0] == (
        3 * gemm + 169343 * 1024 + 14 * 4 * 1024 * 256)


def test_the_runner_drives_the_program_and_is_correct(deep_cell):
    result = main.run_cell(deep_cell, SEED, 0.1, False, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    for name, c in result["checks"].items():
        assert c["value"] < c["limit"] / 10, (name, c)
    assert set(result["metrics"]) == {"train_round_s", "train_peak_gib", "setup_s"}
    window = result["window"]
    assert window["judged"] == window["calls"] >= 1
    assert result["attempted"] == window["calls"] * deep_cell.settings["rounds_per_call"]
    # the params drawn carry P on the hidden layer, in the program's tree order
    drv = deep_cell.runner()
    params = drv.prepare(deep_cell, SEED, "cpu").params0
    assert [list(layer) for layer in params] == [["W", "a1", "a2"], ["W", "a1", "a2", "P"],
                                                 ["W", "a1", "a2"]]
    assert tuple(params[1]["P"].shape) == (4, 1024, 256)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_comes_out_not_correct(deep_cell, fault, monkeypatch):
    plant(monkeypatch, fault)
    result = main.run_cell(deep_cell, SEED + 1, 0.1, False, "cpu", time.perf_counter())
    assert result["correct"] is False, (fault, result["checks"])


def test_a_program_without_the_skip_stops_at_once(deep_cell, monkeypatch):
    """A program whose FedGATConfig lacks ``skip`` fails before any set-up."""
    from repro_torch.core import fedgat_model

    def old_config(*, skip=False, **kw):
        raise TypeError("FedGATConfig.__init__() got an unexpected keyword argument 'skip'")
    monkeypatch.setattr(fedgat_model, "FedGATConfig", old_config)
    t0 = time.perf_counter()
    with pytest.raises(TypeError, match="skip"):
        main.run_cell(deep_cell, SEED, 0.1, False, "cpu", t0)
    assert time.perf_counter() - t0 < 5


def span(name, span_id, parent=None, parent_id=None, device_ms=None):
    return SimpleNamespace(name=name, start_ns=span_id, dur_ns=1, depth=0, parent=parent,
                           span_id=span_id, parent_id=parent_id,
                           device_ns=None if device_ms is None else int(device_ms * 1e6))


def step_spans(first_id, exact_ms, skip_ms):
    """A local step whose forward holds exact_layers with skip spans in it."""
    i = first_id
    out = [span("local_step", i, "step", None, 100.0),
           span("forward", i + 1, "local_step", i, 50.0),
           span("exact_layers", i + 2, "forward", i + 1, exact_ms)]
    out += [span("skip", i + 3 + k, "exact_layers", i + 2, ms) for k, ms in enumerate(skip_ms)]
    return out


def test_the_span_readers_read_the_local_steps_forward_only():
    exact = spec.metric_reader("exact_layers_fwd_ms")
    skip = spec.metric_reader("skip_fwd_ms")
    spans = (step_spans(10, 30.0, [2.0, 1.0]) + step_spans(20, 50.0, [5.0])
             # an evaluation's forward: not a local step's
             + [span("evaluate", 40, "round", None, 70.0),
                span("exact_layers", 41, "evaluate", 40, 1000.0),
                span("skip", 42, "exact_layers", 41, 1000.0),
                # a centralised baseline's forward, outside any local step
                span("forward", 50, None, None, 60.0),
                span("exact_layers", 51, "forward", 50, 1000.0),
                span("skip", 52, "exact_layers", 51, 1000.0)])
    ctx = SimpleNamespace(calls=[{"wall_s": 1.0, "rounds": 1, "spans": spans},
                                 {"wall_s": 1.0, "rounds": 1,
                                  "spans": step_spans(60, 10.0, [3.0])}])
    assert exact(ctx) == pytest.approx(30.0)           # (30 + 50 + 10) / 3
    assert skip(ctx) == pytest.approx(11.0 / 3)        # (3 + 5 + 3) / 3 steps
    # a CPU run's spans (no device time), a program or model without them
    cpu = SimpleNamespace(calls=[{"spans": [
        span(s.name, s.span_id, s.parent, s.parent_id) for s in step_spans(1, 1.0, [1.0])]}])
    assert exact(cpu) is None and skip(cpu) is None
    two_layers = SimpleNamespace(calls=[{"spans": step_spans(1, 12.0, [])}])
    assert exact(two_layers) == pytest.approx(12.0) and skip(two_layers) is None
    assert exact(SimpleNamespace(calls=[{"wall_s": 1.0}])) is None


def test_the_conditioning_reading_moves_every_element_one_ulp():
    """``calibrate_deep.nudged``: each element one float32 ulp up or down,
    both ways taken, the same for the same seed, layers and keys kept."""
    nudged = spec.load_module(spec.BENCH / "calibrate_deep.py", "bench_calibrate_deep").nudged
    gen = torch.Generator().manual_seed(7)
    params = [{"W": torch.rand(4, 6, 5, generator=gen) - 0.5,
               "a1": torch.rand(4, 5, generator=gen) - 0.5}, {"W": -torch.rand(3, 2)}]
    out = nudged(params, SEED)
    assert [list(layer) for layer in out] == [list(layer) for layer in params]
    ups = 0
    for layer, moved in zip(params, out):
        for k, t in layer.items():
            up = moved[k] > t
            assert torch.equal(moved[k], torch.where(up, torch.nextafter(t, t + 1),
                                                     torch.nextafter(t, t - 1)))
            ups += int(up.sum())
    assert 0 < ups < sum(t.numel() for layer in params for t in layer.values())
    assert all(torch.equal(a[k], b[k]) for a, b in zip(out, nudged(params, SEED)) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 31 + 6])
def test_tf32_and_the_dropped_skip_are_not_correct_on_the_card(seed):
    """On the card at the configuration's widths and d 128, B 32, N 40,000:
    the reference in the program's place with TF32 on, or without its
    skip, fails the cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 runs only on a CUDA device")
    from test_bench_control import GRAPH

    cell = cut_cell(CELL, GRAPH)
    drv = cell.runner()
    inputs = drv.prepare(cell, seed, "cuda")
    pr = drv.reference_problem(cell, inputs, "cuda")
    ref = drv.reference_round(cell, pr, inputs)
    for side in (dict(tf32=True), dict(fault="skip_dropped")):
        numbers = drv.compare(cell, pr, inputs, drv.reference_round(cell, pr, inputs, **side),
                              ref)
        assert not is_correct(checks_of(numbers, cell.settings["limits"])), (side, numbers)
