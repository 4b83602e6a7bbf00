"""The port's system benchmarks (``benchmarks_torch/``) against the
reference's (``benchmarks/``), on the CPU, and the trainer's comm gauges:

* ``build_result`` publishes ``comm.upload_scalars``,
  ``comm.download_scalars`` and ``comm.cross_client_edges`` with telemetry
  on, equal to the reference's (host integers);
* ``check_regression``: ``check_file`` and the trajectory compare give the
  reference's messages on every committed root ``BENCH_*.json``, on crafted
  bad files and on the cases of ``tests/test_telemetry.py``; its default
  targets are the port's results directory;
* ``serve_bench --fast``: the reference's keys and its ``queries``,
  ``cache_hits`` and ``cache_misses`` row for row, ``engine ==
  engine_requested``, rows written to ``BENCH_serve.json`` under the
  results directory;
* ``graph_bench``: the structural columns at ``sbm_1k`` equal the
  reference's;
* ``kernel_bench --fast``: the reference's kernels and shapes row for row,
  its columns renamed where the port measures the same thing;
* ``fed_scale_bench`` (vmap): ``lanes`` and ``cohorts_per_round`` equal
  the reference's cohort plan;
* a bench and an example run in a process that loads neither ``jax`` nor
  ``repro``.

Torch cannot draw ``jax.random``'s bits, so timings, accuracies and errors
are held only for finiteness and range.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchmarks.common as j_common
from benchmarks import check_regression as j_cr
from benchmarks import graph_bench as j_graph
from benchmarks import kernel_bench as j_kernel
from benchmarks import serve_bench as j_serve
from benchmarks_torch import check_regression as cr
from benchmarks_torch import common
from benchmarks_torch import fed_scale_bench, graph_bench, kernel_bench, serve_bench

torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]
COMM_GAUGES = ("comm.upload_scalars", "comm.download_scalars", "comm.cross_client_edges")


@pytest.fixture
def results_dir(tmp_path, monkeypatch):
    """Both packages' artifacts go to a temporary directory: the
    reference's root ``BENCH_*.json`` and the port's results stay as they
    are."""
    port_dir = tmp_path / "port"
    monkeypatch.setattr(common, "RESULTS_DIR", port_dir)
    monkeypatch.setattr(j_common, "REPO_ROOT", tmp_path / "reference")
    (tmp_path / "reference").mkdir()
    return port_dir


# ---------------------------------------------------------------------------
# The comm gauges of build_result
# ---------------------------------------------------------------------------

def test_build_result_publishes_the_reference_s_comm_gauges():
    import repro.telemetry as j_telemetry
    from repro.federated import FederatedConfig as JFederatedConfig
    from repro.federated import run_federated as j_run_federated
    from repro.graphs import make_cora_like as j_make_cora_like

    from repro_torch import telemetry
    from repro_torch.federated import FederatedConfig, run_federated
    from repro_torch.graphs import make_cora_like

    kw = dict(method="fedgat", num_clients=4, rounds=1, local_steps=1, seed=0)
    for tel in (telemetry, j_telemetry):
        tel.reset(reset_metrics=True)
        tel.enable()
    try:
        run_federated(make_cora_like("tiny", seed=0), FederatedConfig(**kw), device=CPU)
        j_run_federated(j_make_cora_like("tiny", seed=0), JFederatedConfig(**kw))
        got, want = telemetry.metrics_snapshot(), j_telemetry.metrics_snapshot()
    finally:
        for tel in (telemetry, j_telemetry):
            tel.disable()
            tel.reset(reset_metrics=True)
    for name in COMM_GAUGES:
        assert name in got, sorted(got)
        assert got[name]["value"] == want[name]["value"] > 0, name


# ---------------------------------------------------------------------------
# check_regression
# ---------------------------------------------------------------------------

ROOT_BENCHES = sorted(p.name for p in ROOT.glob("BENCH_*.json"))


def test_every_committed_root_bench_file_is_checked():
    assert ROOT_BENCHES == ["BENCH_fed.json", "BENCH_graph.json", "BENCH_kernel.json",
                            "BENCH_privacy.json", "BENCH_serve.json"]


@pytest.mark.parametrize("name", ROOT_BENCHES)
def test_check_file_and_trajectory_give_the_reference_s_messages(name, capsys):
    path = ROOT / name
    assert cr.check_file(path) == j_cr.check_file(path)
    assert cr.check_trajectory(path, None, 1.5) == j_cr.check_trajectory(path, None, 1.5)
    for rev in ("HEAD", "no-such-revision"):
        assert cr.baseline_rows(path, rev) == j_cr.baseline_rows(path, rev)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]


@pytest.mark.parametrize("rows,problems", [
    ([], 1),
    ([{"p50_ms": float("nan"), "throughput_qps": 1.0}], 1),
    ([{"p50_ms": -1.0, "throughput_qps": 10.0}], 1),
    ([{"throughput_qps": 0.0, "rounds_per_s": 2.0, "peak_rss_mb": -3.0}], 2),
    ([{"epsilon": float("inf"), "noise_multiplier": 0.5}], 1),
    ([{"epsilon": float("inf"), "noise_multiplier": 0.0, "clip": float("inf")}], 0),
    ([{"mechanism": "pack-dp", "epsilon_vs_server": float("inf"), "noise_multiplier": 0.5,
       "pack_noise_multiplier": 0.1}], 0),
    ([{"epsilon": float("inf"), "attack_advantage": 0.1, "noise_multiplier": 0.0},
      {"epsilon": 2.0, "attack_advantage": 0.3, "noise_multiplier": 1.0}], 1),
    ([{"epsilon": float("inf"), "attack_advantage": 0.5, "noise_multiplier": 0.0},
      {"epsilon": 2.0, "attack_advantage": 0.2, "noise_multiplier": 1.0}], 0),
], ids=["empty", "nan", "negative-positive-key", "two-positive-keys", "inf-epsilon-noised",
        "inf-sentinels", "pack-dp-vs-server", "inverted-attack-curve", "monotone-attack-curve"])
def test_check_file_flags_crafted_files_as_the_reference(tmp_path, rows, problems):
    path = tmp_path / "BENCH_crafted.json"
    path.write_text(json.dumps(rows))
    got = cr.check_file(path)
    assert got == j_cr.check_file(path)
    assert len(got) == problems, got


def test_check_file_on_unreadable_json(tmp_path):
    path = tmp_path / "broken.json"
    path.write_text("{not json")
    got = cr.check_file(path)
    assert len(got) == 1 and "unreadable JSON" in got[0]
    assert got[0].split(" (")[0] == j_cr.check_file(path)[0].split(" (")[0]


@pytest.mark.parametrize("cur,probs_want", [
    ([{"name": "serve", "clients": 8, "p99_ms": 12.0, "throughput_qps": 90.0}], []),
    ([{"name": "serve", "clients": 8, "p99_ms": 16.0, "throughput_qps": 100.0}], ["p99_ms"]),
    ([{"name": "serve", "clients": 8, "p99_ms": 10.0, "throughput_qps": 50.0}],
     ["throughput_qps"]),
], ids=["within-band", "slower", "starved"])
def test_trajectory_compare_flags_directional_regressions(cur, probs_want):
    # tests/test_telemetry.py:306-320
    base = [{"name": "serve", "clients": 8, "p99_ms": 10.0, "throughput_qps": 100.0}]
    probs, matched = cr.check_trajectory_rows(cur, [dict(base[0])], tolerance=1.5)
    assert (probs, matched) == j_cr.check_trajectory_rows(cur, [dict(base[0])], tolerance=1.5)
    assert matched == 1 and len(probs) == len(probs_want)
    assert all(key in p for key, p in zip(probs_want, probs))


def test_trajectory_unmatched_rows_are_not_failures():
    # tests/test_telemetry.py:323-327
    base = [{"name": "serve", "clients": 8, "p99_ms": 10.0}]
    cur = [{"name": "serve", "clients": 16, "p99_ms": 500.0}]  # new sweep point
    got = cr.check_trajectory_rows(cur, list(base), tolerance=1.5)
    assert got == j_cr.check_trajectory_rows(cur, list(base), tolerance=1.5) == ([], 0)


def test_trajectory_row_identity_ignores_measured_ints():
    # tests/test_telemetry.py:330-335
    a = {"name": "serve", "clients": 8, "batches": 100, "p99_ms": 1.0}
    b = {"name": "serve", "clients": 8, "batches": 999, "p99_ms": 1.0}
    c = dict(a, clients=16)
    assert cr.row_identity(a) == cr.row_identity(b) == j_cr.row_identity(a)
    assert cr.row_identity(a) != cr.row_identity(c) == j_cr.row_identity(c)


def test_check_regression_defaults_to_the_port_s_results(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(cr, "RESULTS_DIR", tmp_path)
    assert cr.main([]) == 1                                   # nothing there yet
    (tmp_path / "BENCH_serve.json").write_text(json.dumps(
        [{"p50_ms": 1.0, "p99_ms": 2.0, "throughput_qps": 10.0}]))
    (tmp_path / "BENCH_serve_trace.json").write_text(json.dumps({"traceEvents": []}))
    assert cr.main([]) == 0
    assert cr.main(["--trajectory"]) == 0         # never committed: no baseline, a note
    out = capsys.readouterr().out
    assert "check_regression: 1 file(s), 0 problem(s)" in out
    assert "note: trajectory skipped" in out
    (tmp_path / "BENCH_serve.json").write_text(json.dumps([{"p50_ms": 0.0}]))
    assert cr.main([]) == 1
    monkeypatch.setenv("REPRO_BENCH_ALLOW_REGRESSION", "1")
    assert cr.main([str(ROOT / "BENCH_serve.json"), "--trajectory"]) == 0


# ---------------------------------------------------------------------------
# serve_bench, graph_bench, kernel_bench, fed_scale_bench
# ---------------------------------------------------------------------------

def test_serve_bench_fast_rows_are_the_reference_s(results_dir):
    rows = serve_bench.run(fast=True, device=CPU)
    want = j_serve.run(fast=True)
    assert len(rows) == len(want) == 2
    for got, ref in zip(rows, want):
        assert list(got) == list(ref)
        for key in ("dataset", "engine_requested", "clients", "max_batch_size", "queries",
                    "cache_hits", "cache_misses"):
            assert got[key] == ref[key], key
        assert got["engine"] == got["engine_requested"]
        assert all(got[k] > 0 for k in ("p50_ms", "p99_ms", "throughput_qps", "mean_batch"))
    assert "qps" in serve_bench.derived(rows)
    assert serve_bench.kernel_launches(rows) == 2       # one forward a client of the kernel server
    emitted = json.loads((results_dir / "BENCH_serve.json").read_text())
    assert emitted == rows
    assert not (ROOT / "benchmarks_torch" / "BENCH_serve.json").exists()


def test_graph_bench_structural_columns_are_the_reference_s(results_dir):
    from repro.graphs import make_sbm as j_make_sbm

    from repro_torch.graphs import make_sbm

    rows = graph_bench.run(fast=True, device=CPU)
    assert [r["preset"] for r in rows] == ["sbm_1k", "sbm_10k"]
    row = rows[0]
    g, jg = make_sbm("sbm_1k", seed=0), j_make_sbm("sbm_1k", seed=0)
    want = {
        "num_nodes": jg.num_nodes,
        "num_edges": int(jg.num_undirected_edges()),
        "avg_degree": float(jg.degrees().mean()),
        "padded_degree": int(jg.max_degree),
        "dense_adj_mb": jg.num_nodes ** 2 / 2**20,
        "csr_mb": j_graph._graph_bytes(jg) / 2**20,
    }
    for key, value in want.items():
        assert row[key] == value, key
    # The host arrays have the reference's dtypes; on the device the
    # neighbour ids are int64 (the reference's are int32).
    assert graph_bench._graph_bytes(g) == j_graph._graph_bytes(jg)
    assert [a.dtype for a in g if hasattr(a, "dtype")] == [a.dtype for a in jg
                                                           if hasattr(a, "dtype")]
    n, b = g.nbr_idx.shape
    assert row["device_mb"] * 2**20 == g.features.nbytes + 8 * n * b + n * b
    assert set(rows[0]) - set(want) >= {"build_s", "kernel_forward_us", "bucketed_forward_us",
                                        "dense_over_csr", "block_n", "buckets"}
    assert all(r[k] > 0 for r in rows for k in ("build_s", "kernel_forward_us",
                                                 "bucketed_forward_us"))
    assert cr.check_file(results_dir / "BENCH_graph.json") == []


# The reference's kernel_bench columns, renamed where the port measures the
# same thing, and those with no counterpart (the TPU block model).
RENAMED = {"us_ref_jnp": "us_ref_torch", "us_pallas_interpret": "us_kernel",
           "autotune_blocks": "launch_plan"}
NO_COUNTERPART = {"us_default_128x128", "us_autotune"}
PORT_ONLY = {"err_over_tol"}


def test_kernel_bench_rows_are_the_reference_s_kinds_and_shapes(results_dir):
    rows = kernel_bench.run(fast=True, device=CPU)
    want = j_kernel.run(fast=True)
    assert [(r["kernel"], r["shape"]) for r in rows] == [(r["kernel"], r["shape"]) for r in want]
    for got, ref in zip(rows, want):
        keys = {RENAMED.get(k, k) for k in ref} - NO_COUNTERPART
        extra = set(got) - keys - PORT_ONLY
        assert keys <= set(got)
        assert extra == ({"us_kernel", "us_ref_torch"} if got["kernel"] == "cheb_attn_layer"
                         else set())
        assert 0 <= got["err_over_tol"] <= 1 and np.isfinite(got["max_err"])
    assert kernel_bench.expected_launches(True) == {
        "cheb_attn": 28, "flash_attn": 4, "poly_attn": 4, "cheb_attn_backward": 0}
    assert kernel_bench.expected_launches(False)["cheb_attn"] == 4 * (2 + 5 + 9)
    assert json.loads((results_dir / "BENCH_kernel.json").read_text()) == rows


def test_fed_scale_vmap_lanes_and_cohorts_are_the_reference_s(results_dir, monkeypatch):
    from repro.federated.cohort import cohort_lanes, plan_rounds
    from repro.federated.trainer import FederatedConfig as JFederatedConfig
    from repro.federated.trainer import selection_schedule

    monkeypatch.setattr(fed_scale_bench, "BACKENDS", ("vmap",))
    rows = fed_scale_bench.run(fast=True, device=CPU)
    assert [r["num_clients"] for r in rows] == [8, 128]
    for row in rows:
        cfg = JFederatedConfig(method="fedgat", num_clients=row["num_clients"],
                               rounds=row["rounds"], local_steps=2, client_fraction=1.0,
                               seed=0, max_concurrent_clients=8)
        lanes = cohort_lanes(cfg, "vmap")
        plans = plan_rounds(cfg, selection_schedule(cfg)[1], lanes)
        assert row["lanes"] == lanes
        assert row["cohorts_per_round"] == max(p.ids.shape[0] for p in plans)
        assert row["devices"] == 1 and row["peak_device_mb"] is None
        assert row["rounds_per_s"] > 0 and row["peak_rss_mb"] > 0
    assert "rounds/s" in fed_scale_bench.derived(rows)


def test_benches_and_an_example_run_without_jax(tmp_path):
    """kernel, serve and graph benches (fast) and engines_and_privacy run on
    the CPU in a process that never loads jax, repro or benchmarks."""
    code = ("import sys, io, contextlib\n"
            "import benchmarks_torch.common as common, pathlib\n"
            f"common.RESULTS_DIR = pathlib.Path({str(tmp_path)!r})\n"
            "from benchmarks_torch import graph_bench, kernel_bench, serve_bench\n"
            "from examples_torch import engines_and_privacy\n"
            "for mod in (kernel_bench, serve_bench, graph_bench):\n"
            "    assert mod.run(fast=True, device='cpu')\n"
            "with contextlib.redirect_stdout(io.StringIO()):\n"
            "    assert engines_and_privacy.main(['--device', 'cpu']) == 0\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', "
            "'benchmarks'))\n"
            "print(bad)\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": f"{ROOT / 'src'}{os.pathsep}{ROOT}",
             "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "BENCH_graph.json", "BENCH_kernel.json", "BENCH_serve.json"]
