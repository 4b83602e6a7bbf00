"""The port's distributed backends and run manifests against the JAX package.

* The launcher (``repro_torch.launch.multiprocess``), mirroring
  ``tests/test_multiprocess.py``: the protocol's no-op, the CLI's and
  ``launch``'s refusals, a failing worker reaping its sibling, a bound
  coordinator port, a hung gang returning 124, and the collectives rule.
* Two gloo processes on the CPU (K 4 on ``tiny``) against the port's
  in-process vmap loop: fedavg, DP with pairwise masks at fraction 0.5,
  fedadam through its first round (the reference's own backends disagree
  on fedadam from round 2, ROADMAP Queue 3), distgat and fedgcn; curves
  to 1e-6 (``tests/test_multiprocess.py``), params at rtol 1e-3 / atol
  1e-4 but the output layer's ``a1`` (``tests/test_torch_federated.py``'s
  docstring), ε equal, and the ranks' params bit for bit.
* One process against the reference's ``backend="shard_map"`` with the
  reference's initial params: both stream one-lane cohorts (one CPU device
  in this process), the protocol mode too, and with one client both run
  the client mesh; the span tree is round -> cohort -> step.
* Manifests: ``config_hash`` equal to the reference's, ``write_run``'s
  four files, a bundle's manifest through both packages' ``load_bundle``,
  and the serve CLI's ``--telemetry-dir``.

At most four tests spawn processes; each bounds its own wait.
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from repro.core import FedGATConfig as JFedGATConfig
from repro.core.fedgat_model import FedGAT as JFedGAT
from repro.federated import trainer as jtrainer
from repro.federated.partition import client_subgraph as j_client_subgraph
from repro.federated.partition import dirichlet_partition as j_dirichlet_partition
from repro.graphs import make_cora_like as j_make_cora_like
from repro.privacy import PrivacyConfig as JPrivacyConfig
from repro.serving import load_bundle as j_load_bundle
from repro.telemetry import config_hash as j_config_hash
from repro_torch import telemetry
from repro_torch.core import FedGATConfig
from repro_torch.federated import cohort, sharded
from repro_torch.federated.partition import dirichlet_partition
from repro_torch.federated.trainer import FederatedConfig, run_federated
from repro_torch.graphs import make_cora_like
from repro_torch.launch import multiprocess as mp
from repro_torch.launch import serve as serve_cli
from repro_torch.privacy import PrivacyConfig
from repro_torch.serving import load_bundle, save_bundle

torch.set_num_threads(1)

CPU = torch.device("cpu")
CURVE_ATOL = 1e-6                    # tests/test_multiprocess.py
RTOL, ATOL = 1e-3, 1e-4              # final params, as tests/test_torch_federated.py
NOISE_ONLY = {(1, "a1")}             # see tests/test_torch_federated.py
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SPAWN_TIMEOUT = 300                  # seconds a spawning test may wait for its processes

MODEL = dict(engine="kernel", degree=10)
TWO_CPU_RANKS = {"axis_names": ["clients"], "axis_sizes": [4], "num_devices": 2,
                 "num_processes": 2, "platform": "cpu"}

# The gang's runs: FederatedConfig fields (model and privacy as dicts).
GANG_CASES = {
    "fedavg": dict(num_clients=4, rounds=2, local_steps=2, model=MODEL),
    "dp_pairwise": dict(num_clients=4, rounds=2, local_steps=2, client_fraction=0.5,
                        model=MODEL,
                        privacy=dict(noise_multiplier=0.5, clip=1.0, secure_agg=True,
                                     secure_agg_mode="pairwise")),
    "fedadam": dict(num_clients=4, rounds=1, local_steps=2, aggregator="fedadam", model=MODEL),
    "distgat": dict(method="distgat", num_clients=4, rounds=2, local_steps=2, model=MODEL),
    "fedgcn": dict(method="fedgcn", num_clients=4, rounds=2, local_steps=2, model=MODEL),
}

WORKER = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import multiprocess as mp
rank, nproc, collectives = mp.initialize_worker(device="cpu")
import torch.distributed as dist
from repro_torch.core import FedGATConfig
from repro_torch.federated.trainer import FederatedConfig, param_tree, run_federated
from repro_torch.graphs import make_cora_like
from repro_torch.privacy import PrivacyConfig
out, cases = sys.argv[1], json.loads(sys.argv[2])
g = make_cora_like("tiny", seed=0)
try:
    for name, kw in cases.items():
        kw = dict(kw)
        cfg = FederatedConfig(model=FedGATConfig(**kw.pop("model")),
                              privacy=PrivacyConfig(**kw.pop("privacy", {})), **kw)
        res = run_federated(g, cfg, backend="shard_map", device="cpu")
        torch.save({"collectives": collectives, "val_curve": res["val_curve"],
                    "test_curve": res["test_curve"], "best_test": res["best_test"],
                    "epsilon": res["epsilon"], "mesh": res["mesh"],
                    "params": param_tree(res["params"])}, f"{out}/{name}.{rank}.pt")
finally:
    dist.destroy_process_group()
"""


def _env_with_src():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def tiny():
    return make_cora_like("tiny", seed=0), j_make_cora_like("tiny", seed=0)


def _configs(**kw):
    model = kw.pop("model", {})
    privacy = kw.pop("privacy", {})
    return (FederatedConfig(model=FedGATConfig(**model), privacy=PrivacyConfig(**privacy), **kw),
            jtrainer.FederatedConfig(model=JFedGATConfig(**model),
                                     privacy=JPrivacyConfig(**privacy), **kw))


def _reference_params(jcfg, jg):
    """The initial params the reference's drivers draw for ``jcfg``
    (``k_pack, k_init = split(PRNGKey(seed))``), as numpy."""
    _, k_init = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    params = JFedGAT(jtrainer.method_model_config(jcfg)).init(k_init, jg)
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _as_numpy(layer_value):
    if isinstance(layer_value, torch.Tensor):
        return layer_value.detach().numpy()
    return np.asarray(layer_value)


def _assert_curves_close(a, b):
    np.testing.assert_allclose(a["val_curve"], b["val_curve"], atol=CURVE_ATOL)
    np.testing.assert_allclose(a["test_curve"], b["test_curve"], atol=CURVE_ATOL)


def _assert_params_close(got, want, skip=NOISE_ONLY):
    for li, (layer, wlayer) in enumerate(zip(got, want)):
        assert set(layer.keys()) == set(wlayer.keys())
        for k in wlayer:
            if (li, k) not in skip:
                np.testing.assert_allclose(_as_numpy(layer[k]), _as_numpy(wlayer[k]),
                                           rtol=RTOL, atol=ATOL, err_msg=f"layer {li} {k}")


# ---------------------------------------------------------------------------
# The launcher (no processes)
# ---------------------------------------------------------------------------

def test_initialize_worker_is_noop_without_protocol():
    assert not mp.worker_env_active({})
    assert mp.initialize_worker({}) == (0, 1, None)
    one = {mp.ENV_COORDINATOR: "127.0.0.1:1", mp.ENV_PROCESS_ID: "0",
           mp.ENV_NUM_PROCESSES: "1", mp.ENV_DEVICES: "1"}
    assert mp.worker_env_active(one) and mp.initialize_worker(one) == (0, 1, None)


def test_cli_rejects_too_few_devices():
    with pytest.raises(SystemExit) as ei:
        mp.main(["--processes", "2", "--devices-per-process", "2", "--clients", "8"])
    assert "8 clients" in str(ei.value)


def test_launch_rejects_bad_counts():
    with pytest.raises(ValueError):
        mp.launch(["true"], processes=0, devices_per_process=1)
    with pytest.raises(ValueError):
        mp.launch(["true"], processes=1, devices_per_process=0)


def test_bound_coordinator_port_is_a_clear_error():
    """No hang, no spawn: the launcher refuses a busy port up front."""
    with socket.socket() as blocker:
        blocker.bind(("127.0.0.1", 0))
        blocker.listen(1)
        port = blocker.getsockname()[1]
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="already in use"):
            mp.launch([sys.executable, "-c", "print('never runs')"],
                      processes=2, devices_per_process=1, coordinator_port=port)
        assert time.monotonic() - t0 < 5


@pytest.mark.parametrize("device,cards,processes,want", [
    ("cpu", 0, 2, "gloo"),
    ("cpu", 4, 4, "gloo"),
    ("cuda", 2, 2, "nccl"),
    ("cuda", 4, 2, "nccl"),
    ("cuda", 1, 2, "gloo"),
    ("cuda", 2, 4, "gloo"),
])
def test_collectives_rule(monkeypatch, device, cards, processes, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mp.collectives_for(device, processes) == want


# ---------------------------------------------------------------------------
# The launcher's failure modes (torch-free worker commands)
# ---------------------------------------------------------------------------

def test_worker_failure_propagates_and_reaps_siblings(tmp_path):
    """Worker 1 exits 7 at once; worker 0 would sleep for minutes. The
    launcher returns 7 fast and leaves no worker behind."""
    pid_file = tmp_path / "survivor.pid"
    script = (
        "import os, sys, time\n"
        f"if os.environ['{mp.ENV_PROCESS_ID}'] == '1':\n"
        "    sys.exit(7)\n"
        f"open({str(pid_file)!r}, 'w').write(str(os.getpid()))\n"
        "time.sleep(300)\n"
    )
    t0 = time.monotonic()
    code = mp.launch([sys.executable, "-c", script], processes=2, devices_per_process=1,
                     timeout=120)
    assert code == 7
    assert time.monotonic() - t0 < 60
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not pid_file.exists():
        time.sleep(0.05)
    if pid_file.exists():  # it may have been killed before writing
        survivor = int(pid_file.read_text())
        try:
            os.kill(survivor, 0)
            alive = True
        except OSError:
            alive = False
        assert not alive, f"worker {survivor} survived the reap"


def test_launch_timeout_bounds_a_hung_gang():
    t0 = time.monotonic()
    code = mp.launch([sys.executable, "-c", "import time; time.sleep(300)"],
                     processes=2, devices_per_process=1, timeout=3)
    assert code == 124
    assert time.monotonic() - t0 < 30


# ---------------------------------------------------------------------------
# Two gloo processes on the CPU against the vmap loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Every GANG_CASES run on two gloo ranks, each rank's result loaded."""
    out = tmp_path_factory.mktemp("gang")
    code = mp.launch([sys.executable, "-c", WORKER, str(out), json.dumps(GANG_CASES)],
                     processes=2, devices_per_process=2, timeout=SPAWN_TIMEOUT,
                     env=_env_with_src())
    assert code == 0, f"the gang exited {code}"
    return {name: [torch.load(out / f"{name}.{rank}.pt") for rank in range(2)]
            for name in GANG_CASES}


@pytest.mark.parametrize("name", list(GANG_CASES))
def test_two_ranks_match_the_vmap_loop(tiny, gang, name):
    g, _ = tiny
    cfg, _ = _configs(**GANG_CASES[name])
    loop = run_federated(g, cfg, device=CPU)
    got = gang[name][0]
    _assert_curves_close(got, loop)
    assert abs(got["best_test"] - loop["best_test"]) < CURVE_ATOL
    _assert_params_close(got["params"], loop["params"])
    assert got["epsilon"] == loop["epsilon"]
    assert (got["epsilon"] is not None) == (name == "dp_pairwise")
    assert got["mesh"] == TWO_CPU_RANKS and loop["mesh"] is None


@pytest.mark.parametrize("name", list(GANG_CASES))
def test_ranks_end_bit_identical(gang, name):
    r0, r1 = gang[name]
    assert r0["collectives"] == r1["collectives"] == "gloo"
    assert r0["val_curve"] == r1["val_curve"] and r0["test_curve"] == r1["test_curve"]
    for layer0, layer1 in zip(r0["params"], r1["params"]):
        for k in layer0:
            assert torch.equal(layer0[k], layer1[k]), k


def test_cli_trains_two_processes_on_the_cpu(tiny, tmp_path):
    out = tmp_path / "mp.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.multiprocess",
           "--processes", "2", "--devices-per-process", "2", "--clients", "4",
           "--rounds", "2", "--local-steps", "1", "--engine", "direct", "--degree", "8",
           "--dataset", "tiny", "--device", "cpu", "--timeout", str(SPAWN_TIMEOUT),
           "--out", str(out)]
    res = subprocess.run(cmd, env=_env_with_src(), capture_output=True, text=True,
                         timeout=SPAWN_TIMEOUT + 30)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RESULT " in res.stdout and "collectives gloo" in res.stdout
    summary = json.loads(out.read_text())
    assert summary["num_processes"] == 2 and summary["backend"] == "shard_map"
    assert summary["mesh"] == TWO_CPU_RANKS
    g, _ = tiny
    ref = run_federated(g, FederatedConfig(num_clients=4, rounds=2, local_steps=1,
                                           model=FedGATConfig(engine="direct", degree=8)),
                        device=CPU)
    _assert_curves_close(summary, ref)
    assert abs(ref["best_test"] - summary["best_test"]) < CURVE_ATOL


# ---------------------------------------------------------------------------
# One process against the reference's shard_map backend
# ---------------------------------------------------------------------------

REF_CASES = {
    "fedavg": dict(num_clients=4, rounds=2, local_steps=2, model=MODEL),
    "protocol": dict(num_clients=4, rounds=2, local_steps=2, model=MODEL,
                     privacy=dict(secure_agg=True)),
    "fraction": dict(num_clients=4, rounds=3, local_steps=1, client_fraction=0.5, model=MODEL),
    "one_client": dict(num_clients=1, rounds=2, local_steps=2, model=MODEL),
}


@pytest.mark.parametrize("name", list(REF_CASES))
def test_one_process_matches_the_reference_shard_map(tiny, name):
    g, jg = tiny
    cfg, jcfg = _configs(**REF_CASES[name])
    res = run_federated(g, cfg, backend="shard_map", device=CPU,
                        params=_reference_params(jcfg, jg))
    jres = jtrainer.run_federated(jg, jcfg, backend="shard_map")
    _assert_curves_close(res, jres)
    _assert_params_close(res["params"], jres["params"])
    assert res["mesh"] == jres["mesh"]
    assert res["cohort"] == jres["cohort"]
    if name == "one_client":
        assert res["mesh"]["axis_names"] == ["clients"] and res["cohort"] is None
    else:
        assert res["cohort"]["lanes"] == 1 and res["mesh"]["axis_names"] == ["lanes"]
    assert res["manifest"]["config_hash"] == jres["manifest"]["config_hash"]
    assert res["manifest"]["mesh"] == jres["manifest"]["mesh"]


def test_zero_rounds_is_setup_only(tiny):
    g, jg = tiny
    cfg, jcfg = _configs(num_clients=4, rounds=0, model=MODEL)
    res = run_federated(g, cfg, backend="shard_map", device=CPU)
    jres = jtrainer.run_federated(jg, jcfg, backend="shard_map")
    assert res["val_curve"] == jres["val_curve"] == []
    assert res["mesh"] is None and jres["mesh"] is None and res["cohort"] is None


def test_one_process_span_tree_is_round_cohort_step(tiny):
    g, _ = tiny
    cfg, _ = _configs(num_clients=4, rounds=1, local_steps=1, model=MODEL)
    telemetry.reset()
    telemetry.enable()
    try:
        run_federated(g, cfg, backend="shard_map", device=CPU)
        trace = telemetry.export_chrome_trace()
        records = telemetry.records()
    finally:
        telemetry.disable()
        telemetry.reset()
    parent = {r.name: r.parent for r in records}
    assert parent["step"] == "cohort" and parent["cohort"] == "round" and parent["round"] is None
    assert {"round", "cohort", "step", "staging"} <= {e["name"] for e in trace["traceEvents"]}


def test_cohorts_refuse_a_process_group_of_more_ranks(tiny, monkeypatch):
    g, _ = tiny
    cfg, _ = _configs(num_clients=4, rounds=1, local_steps=1, model=MODEL)
    monkeypatch.setattr(cohort, "process_count", lambda: 2)
    with pytest.raises(NotImplementedError, match="single-process mesh"):
        cohort.run_cohort_rounds(g, cfg, backend="shard_map", device=CPU)
    assert cohort.cohort_lanes(cfg, "shard_map", num_devices=3) == 3


def test_client_layout_blocks_and_subgraphs(tiny, monkeypatch):
    g, jg = tiny
    assert sharded.client_layout(4) == sharded.ClientLayout(4, 0, 1)
    assert sharded.addressable_clients(sharded.ClientLayout(8, 1, 2)) == [4, 5, 6, 7]
    layout = sharded.ClientLayout(4, 1, 2)
    subs = sharded.process_client_subgraphs(g, dirichlet_partition(g.labels, 4, 1.0, 0), layout)
    jpart = j_dirichlet_partition(jg.labels, 4, 1.0, 0)
    assert sorted(subs) == [2, 3]
    for k, sub in subs.items():
        want = j_client_subgraph(jg, jpart, k, 1)
        np.testing.assert_array_equal(sub.nodes, want.nodes)
        np.testing.assert_array_equal(sub.local_mask, want.local_mask)
    monkeypatch.setattr(sharded, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="must divide evenly over 3 processes"):
        sharded.client_layout(4)


# ---------------------------------------------------------------------------
# Run manifests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {},
    dict(num_clients=8, backend="shard_map", client_fraction=0.5, model=dict(degree=10)),
    dict(method="distgat", privacy=dict(noise_multiplier=0.5, clip=1.0, secure_agg=True)),
])
def test_config_hash_equals_the_reference(kw):
    cfg, jcfg = _configs(**kw)
    assert telemetry.config_hash(cfg) == j_config_hash(jcfg)
    assert telemetry.config_hash(cfg.model) == j_config_hash(jcfg.model)
    assert telemetry.config_hash(cfg) != telemetry.config_hash(dataclasses.replace(cfg, seed=1))
    m = telemetry.manifest(cfg)
    assert m["config_hash"] == j_config_hash(jcfg) and m["backend"] == cfg.backend
    assert set(m["versions"]) == {"python", "torch", "cuda", "numpy"}
    assert m["process_count"] == 1 and m["device_count"] == torch.cuda.device_count()


def test_write_run_writes_its_four_files(tmp_path):
    cfg, _ = _configs()
    telemetry.reset()
    telemetry.enable()
    try:
        with telemetry.span("outer", k=1):
            with telemetry.span("inner"):
                telemetry.event("probe", value=3)
        paths = telemetry.write_run(str(tmp_path / "run"), cfg)
    finally:
        telemetry.disable()
        telemetry.reset()
    assert sorted(paths) == ["events", "manifest", "metrics", "trace"]
    assert all(os.path.exists(p) for p in paths.values())
    trace = json.loads(open(paths["trace"]).read())
    inner = [e for e in trace["traceEvents"] if e["name"] == "inner"]
    assert inner[0]["args"]["parent"] == "outer" and inner[0]["args"]["depth"] == 1
    assert json.loads(open(paths["events"]).readline())["value"] == 3
    assert json.loads(open(paths["manifest"]).read())["config_hash"] == telemetry.config_hash(cfg)
    assert isinstance(json.loads(open(paths["metrics"]).read()), dict)


def test_bundle_manifest_survives_both_loaders(tiny, tmp_path):
    g, jg = tiny
    cfg, jcfg = _configs(num_clients=2, rounds=1, local_steps=1, model=MODEL)
    res = run_federated(g, cfg, device=CPU)
    path = save_bundle(str(tmp_path / "b"), res["params"], cfg, step=1)
    saved = json.loads((path / "meta.json").read_text())["manifest"]
    assert saved["config_hash"] == j_config_hash(jcfg)
    assert load_bundle(str(path), g, device=CPU).meta["manifest"] == saved
    assert j_load_bundle(str(path), jg).meta["manifest"] == saved


def test_serve_cli_writes_the_telemetry_dir(tmp_path, capsys):
    out = tmp_path / "telemetry"
    try:
        serve_cli.main(["--mode", "graph", "--fast", "--device", "cpu",
                        "--telemetry-dir", str(out)])
    finally:
        telemetry.disable()
        telemetry.reset()
    assert "telemetry:" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["events.jsonl", "manifest.json", "metrics.json",
                                       "trace.json"]
    assert json.loads((out / "trace.json").read_text())["traceEvents"]
