"""The port's paper-experiment drivers (``benchmarks_torch/``) against the
reference's (``benchmarks/``), held as far as torch can follow
``jax.random``:

* exactly: every row of ``thm2_cheb_error`` (numpy only), every row of
  ``fig3_comm`` (``rounds=0``: the host-side comm report), and
  ``fig6_vector``'s ``vector_scalars``, ``matrix_scalars`` and ``speedup``
  (its training is stubbed out here; ``tests/test_torch_paper_sweeps*.py``
  hold its accuracies);
* given the reference's initial params (``repro.core.init_params`` under
  ``PRNGKey(seed)``, carried over by ``params_from_numpy``): every value of
  ``thm35_error_prop`` and ``stability_basis`` at rtol 1e-4 / atol 1e-6
  (maxima of float32 errors), ``err_power`` at rtol 1e-3 where finite, and
  ``thm3_satisfied`` equal.

Also: discovery finds exactly the eight drivers and the six system
benchmarks (the reference's set), and importing them, the regression guard,
the two smokes and the four examples loads neither ``jax`` nor ``repro``.
"""
import inspect
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from benchmarks import fig3_comm as j_fig3
from benchmarks import fig6_vector as j_fig6
from benchmarks import stability_basis as j_stability
from benchmarks import thm2_cheb_error as j_thm2
from benchmarks import thm35_error_prop as j_thm35
from benchmarks_torch import fig3_comm, fig6_vector, stability_basis, thm2_cheb_error
from benchmarks_torch import thm35_error_prop
from benchmarks_torch.run import _NON_BENCHES, discover_benches
from repro.core import FedGATConfig as JFedGATConfig
from repro.core import init_params as j_init_params
from repro.graphs import make_cora_like as j_make_cora_like
from repro_torch.core import params_from_numpy
from repro_torch.graphs import make_cora_like

torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL, ATOL = 1e-4, 1e-6          # maxima of float32 errors
POWER_RTOL = 1e-3                # err_power at high degree: cancellation in the monomials
ROOT = pathlib.Path(__file__).resolve().parents[1]
DRIVERS = ["fig2_clients", "fig3_comm", "fig5_degree", "fig6_vector", "stability_basis",
           "table1_accuracy", "thm2_cheb_error", "thm35_error_prop"]
SYSTEM_BENCHES = ["fed_scale_bench", "graph_bench", "kernel_bench", "privacy_audit",
                  "privacy_tradeoff", "serve_bench"]
SMOKES = ["large_graph_smoke", "telemetry_smoke"]
EXAMPLES = ["e2e_federated_training", "engines_and_privacy", "lm_train_smoke", "quickstart"]


def _reference_params(seed):
    jg = j_make_cora_like("tiny", seed=seed)
    params = j_init_params(jax.random.PRNGKey(seed), jg.feature_dim, jg.num_classes,
                           JFedGATConfig())
    return params_from_numpy([{k: np.asarray(v) for k, v in layer.items()}
                              for layer in params], device=CPU)


def _assert_rows(rows, jrows, close=(), power=()):
    assert len(rows) == len(jrows)
    for row, jrow in zip(rows, jrows):
        assert list(row) == list(jrow)
        for k, want in jrow.items():
            got = row[k]
            if k in power:
                assert math.isfinite(got) == math.isfinite(want), (k, got, want)
                if math.isfinite(want):
                    assert got == pytest.approx(want, rel=POWER_RTOL), (k, got, want)
            elif k in close:
                assert got == pytest.approx(want, rel=RTOL, abs=ATOL), (k, got, want)
            else:
                assert got == want, (k, got, want)
                assert type(got) is type(want), (k, type(got), type(want))


@pytest.mark.parametrize("fast", [True, False])
def test_thm2_rows_are_the_reference_s(fast):
    rows = thm2_cheb_error.run(fast=fast, device=CPU)
    _assert_rows(rows, j_thm2.run(fast=fast))
    assert thm2_cheb_error.derived(rows) == j_thm2.derived(rows)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_thm35_rows_from_the_reference_params(fast, seed):
    g = make_cora_like("tiny", seed=seed)
    rows = thm35_error_prop._rows(fast, g, _reference_params(seed), CPU)
    jrows = j_thm35.run(fast=fast, seed=seed)
    _assert_rows(rows, jrows, close={"eps_score", "alpha_err", "thm3_bound", "layer1_err",
                                     "final_logit_err"})
    assert all(r["thm3_satisfied"] for r in rows)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_stability_rows_from_the_reference_params(fast, seed):
    g = make_cora_like("tiny", seed=seed)
    rows = stability_basis._rows(fast, g, _reference_params(seed), CPU)
    jrows = j_stability.run(fast=fast, seed=seed)
    _assert_rows(rows, jrows, close={"err_chebyshev"}, power={"err_power"})


@pytest.mark.parametrize("module", [thm35_error_prop, stability_basis])
def test_theorem_drivers_draw_their_own_params(module):
    """``run`` draws from ``torch.Generator().manual_seed(seed)``: the same
    seed, the same rows; the rows have the reference's keys."""
    a = module.run(fast=True, seed=3, device=CPU)
    assert a == module.run(fast=True, seed=3, device=CPU)
    assert [list(r) for r in a] == [list(r) for r in
                                    module._rows(True, make_cora_like("tiny", seed=3),
                                                 _reference_params(3), CPU)]
    assert all(math.isfinite(v) for r in a for v in r.values() if isinstance(v, float))
    assert isinstance(module.derived(a), str)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("dataset,seed", [("cora_like", 0), ("tiny", 2)])
def test_fig3_rows_are_the_reference_s(fast, dataset, seed):
    rows = fig3_comm.run(fast=fast, dataset=dataset, seed=seed, device=CPU)
    jrows = j_fig3.run(fast=fast, dataset=dataset, seed=seed)
    _assert_rows(rows, jrows)
    assert fig3_comm.derived(rows) == j_fig3.derived(jrows)


def test_fig3_rows_on_the_shard_map_backend():
    rows = fig3_comm.run(fast=True, backend="shard_map", device=CPU)
    jrows = j_fig3.run(fast=True)
    assert [r["backend"] for r in rows] == ["shard_map"] * len(jrows)
    _assert_rows([dict(r, backend="vmap") for r in rows], jrows)


class _NoTraining:
    """Stands in for a Trainer: fig6's comm columns need no training."""

    def __init__(self, cfg, **kwargs):
        self.cfg = cfg

    def run(self, g, **kwargs):
        return {"best_test": 0.5}


@pytest.mark.parametrize("fast", [True, False])
def test_fig6_comm_columns_are_the_reference_s(monkeypatch, fast):
    import repro.federated
    import repro_torch.federated

    monkeypatch.setattr(repro_torch.federated, "Trainer", _NoTraining)
    monkeypatch.setattr(repro.federated, "Trainer", _NoTraining)
    rows = fig6_vector.run(fast=fast, device=CPU)
    jrows = j_fig6.run(fast=fast)
    _assert_rows(rows, jrows)
    assert {r["clients"] for r in rows} == set(fig6_vector.clients_for(fast))
    assert fig6_vector.derived(rows) == j_fig6.derived(jrows)


def test_discovery_finds_exactly_the_eight_drivers():
    """Discovery finds the eight paper drivers and the six system
    benchmarks, the modules the reference's discovery finds, and nothing
    else on disk but the two smokes (no ``run``/``derived``, as in the
    reference). Each ``run`` takes the reference's arguments and then
    ``device``, before a trailing ``**_``."""
    from benchmarks.run import discover_benches as reference_discover

    benches = discover_benches()
    names = [name for name, _ in benches]
    assert names == sorted(DRIVERS + SYSTEM_BENCHES)
    assert names == [name for name, _ in reference_discover()]
    on_disk = sorted(p.stem for p in (ROOT / "benchmarks_torch").glob("*.py")
                     if p.stem not in _NON_BENCHES and not p.stem.startswith("_"))
    assert on_disk == sorted(names + SMOKES)
    for name, mod in benches:
        assert mod.__name__ == f"benchmarks_torch.{name}"
        ref = __import__(f"benchmarks.{name}", fromlist=["run"])
        assert callable(mod.run) and callable(mod.derived)
        # The reference's arguments, plus the device (before a trailing **_).
        ref_params = list(inspect.signature(ref.run).parameters.values())
        want = [p.name for p in ref_params]
        if ref_params and ref_params[-1].kind is inspect.Parameter.VAR_KEYWORD:
            want.insert(len(want) - 1, "device")
        else:
            want.append("device")
        assert list(inspect.signature(mod.run).parameters) == want


def test_drivers_import_neither_jax_nor_the_reference():
    """Every discovered bench, the regression guard, the two smokes and the
    four examples load neither ``jax`` nor ``repro`` nor ``benchmarks``."""
    others = ["benchmarks_torch.check_regression"] + [
        f"benchmarks_torch.{name}" for name in SMOKES] + [
        f"examples_torch.{name}" for name in EXAMPLES]
    code = ("import importlib, sys\n"
            "from benchmarks_torch.run import discover_benches\n"
            "import benchmarks_torch.common\n"
            "names = [n for n, _ in discover_benches()]\n"
            f"for m in {others!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', "
            "'benchmarks'))\n"
            "print(len(names), bad)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}"},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split(maxsplit=1) == ["14", "[]\n"]


def test_figure_cli_saves_rows_and_prints_the_csv(tmp_path, monkeypatch, capsys):
    from benchmarks_torch import common

    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path)
    common.figure_cli(fig3_comm.run, fig3_comm.derived, "fig3_comm", fig3_comm.max_clients,
                      argv=["--fast", "--device", "cpu", "--dataset", "tiny"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert out[1].startswith("fig3_comm,") and "growth_2to20clients=" in out[1]
    saved = json.loads((tmp_path / "fig3_comm.json").read_text())
    assert saved == fig3_comm.run(fast=True, dataset="tiny", device=CPU)
    with pytest.raises(SystemExit):
        common.figure_cli(fig3_comm.run, fig3_comm.derived, "fig3_comm",
                          fig3_comm.max_clients, argv=["--processes", "2", "--device", "cpu"])
