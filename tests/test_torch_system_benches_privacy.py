"""The port's privacy benchmarks (``benchmarks_torch/privacy_audit.py``,
``privacy_tradeoff.py``) against the reference's, at ``--fast`` on
``tiny``, on the CPU: the rows' keys and configuration columns, and the
accountant's columns (``epsilon``, ``epsilon_vs_server``, ``trust_model``)
equal row for row. Torch cannot draw ``jax.random``'s bits, so accuracies
and attack numbers are held only for finiteness and range.
"""
import math

import pytest
import torch

import benchmarks.common as j_common
from benchmarks import privacy_audit as j_audit
from benchmarks import privacy_tradeoff as j_tradeoff
from benchmarks_torch import common, privacy_audit, privacy_tradeoff
from benchmarks_torch.check_regression import check_file

torch.set_num_threads(1)

CPU = torch.device("cpu")
EXACT = ("dataset", "backend", "mechanism", "attack", "score", "noise_multiplier",
         "pack_noise_multiplier", "clip", "rounds", "clients", "client_fraction",
         "local_steps", "seed", "epsilon", "epsilon_vs_server", "trust_model")
IN_UNIT = ("acc", "attack_auc", "attack_tpr", "attack_fpr")


@pytest.fixture
def results_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(common, "RESULTS_DIR", tmp_path / "port")
    monkeypatch.setattr(j_common, "REPO_ROOT", tmp_path)
    return tmp_path / "port"


def _assert_rows(rows, want):
    assert len(rows) == len(want)
    for got, ref in zip(rows, want):
        assert list(got) == list(ref)
        for key in EXACT:
            if key in ref:
                assert got[key] == ref[key], key
        for key in IN_UNIT:
            if key in ref:
                assert 0.0 <= got[key] <= 1.0, key
        for key, value in got.items():
            if isinstance(value, float) and key not in ("epsilon", "epsilon_vs_server", "clip"):
                assert math.isfinite(value), key


def test_privacy_audit_fast_rows_are_the_reference_s(results_dir):
    rows = privacy_audit.run(fast=True, dataset="tiny", device=CPU)
    want = j_audit.run(fast=True, dataset="tiny")
    _assert_rows(rows, want)
    assert [r["noise_multiplier"] for r in rows] == list(privacy_audit._FAST_GRID)
    assert all(-1.0 <= r["attack_advantage"] <= 1.0 for r in rows)
    assert "advantage@eps=inf=" in privacy_audit.derived(rows)
    assert check_file(results_dir / "BENCH_privacy.json") == []


@pytest.mark.parametrize("backend", ["vmap"])
def test_privacy_tradeoff_fast_rows_are_the_reference_s(results_dir, backend):
    rows = privacy_tradeoff.run(fast=True, dataset="tiny", backend=backend, device=CPU)
    want = j_tradeoff.run(fast=True, dataset="tiny", backend=backend)
    _assert_rows(rows, want)
    assert [r["mechanism"] for r in rows] == ["update-dp"] * 3 + ["pack-dp"] * 2
    assert privacy_tradeoff.derived(rows).startswith("acc@eps=inf=")
