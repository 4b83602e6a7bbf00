"""The serving slice end to end: a bundle written by the JAX package's
Trainer and ``save_bundle`` served by both packages' servers with
``engine="kernel"``, plus the port's isolation and device rules."""
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch


from repro.core import FedGATConfig as JFedGATConfig
from repro.federated.trainer import FederatedConfig, Trainer
from repro.graphs import make_cora_like as j_make_cora_like
from repro.serving import GraphDelta as JGraphDelta
from repro.serving import GraphInferenceServer as JServer
from repro.serving import MicroBatcher as JMicroBatcher
from repro.serving import Query as JQuery
from repro.serving import save_bundle
from repro_torch.core import UnknownEngineError
from repro_torch.graphs import make_cora_like
from repro_torch.kernels.cheb_attn import cheb_attn
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import (
    GraphDelta,
    GraphInferenceServer,
    MicroBatcher,
    Query,
    client_pack_key,
    load_bundle,
)

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def tiny():
    return make_cora_like("tiny", seed=0), j_make_cora_like("tiny", seed=0)


@pytest.fixture(scope="module")
def bundle(tiny, tmp_path_factory):
    """One JAX-trained bundle for the whole file (as tests/test_serving.py)."""
    cfg = FederatedConfig(
        method="fedgat", num_clients=2, rounds=2, local_steps=1, seed=0,
        model=JFedGATConfig(),
    )
    res = Trainer(cfg).run(tiny[1])
    path = tmp_path_factory.mktemp("bundle") / "ckpt"
    save_bundle(str(path), res["params"], cfg, step=2)
    return str(path), res["params"]


def _stream(num_nodes, num_clients, n=40, seed=0):
    rng = np.random.default_rng(seed)
    clients = rng.integers(0, num_clients, size=n)
    nodes = rng.integers(0, num_nodes, size=n)
    arrivals = np.cumsum(rng.exponential(1.0 / 2000.0, size=n)).tolist()
    return list(zip(clients.tolist(), nodes.tolist())), arrivals


def _fake_clock():
    t = [0.0]

    def timer():
        t[0] += 1e-4
        return t[0]

    return timer


def test_port_serves_a_jax_bundle_like_the_jax_server(tiny, bundle):
    g, jg = tiny
    path, _ = bundle
    jserver = JServer.from_checkpoint(path, jg, engine="kernel")
    assert jserver.engine_fallback is None       # the reference went through cheb_attn
    server = GraphInferenceServer.from_checkpoint(path, g, engine="kernel", device="cpu")
    assert server.stats()["engine_fallback"] is None

    pairs, arrivals = _stream(g.num_nodes, server.num_clients)
    jres = JMicroBatcher(jserver.serve_batch, max_batch_size=8, timer=_fake_clock()).run(
        [JQuery(c, n) for c, n in pairs], arrivals)
    tb = MicroBatcher(server.serve_batch, max_batch_size=8, timer=_fake_clock())
    res = tb.run([Query(c, n) for c, n in pairs], arrivals)
    assert [r.label for r in res] == [r.label for r in jres]
    np.testing.assert_allclose(
        np.stack([r.logits for r in res]), np.stack([r.logits for r in jres]),
        rtol=RTOL, atol=ATOL,
    )
    for key in ("hits", "misses", "entries"):
        assert server.stats()["cache"][key] == jserver.stats()["cache"][key], key
    assert tb.stats.summary()["batches"] == 5.0

    rng = np.random.default_rng(1)
    m = 3
    feats = g.features[rng.integers(0, g.num_nodes, size=m)]
    edges = np.stack([np.arange(g.num_nodes, g.num_nodes + m),
                      rng.integers(0, g.num_nodes, size=m)], axis=1)
    rep = server.apply_update(GraphDelta(features=feats, edges=edges))
    jrep = jserver.apply_update(JGraphDelta(features=feats, edges=edges))
    assert rep["num_nodes"] == jrep["num_nodes"] == g.num_nodes + m
    assert rep["drift"] == jrep["drift"]
    post = [(c, n) for c in (0, 1) for n in (0, g.num_nodes, g.num_nodes + m - 1)]
    got = server.serve_batch([Query(c, n) for c, n in post])
    want = jserver.serve_batch([JQuery(c, n) for c, n in post])
    np.testing.assert_allclose(np.stack([r.logits for r in got]),
                               np.stack([r.logits for r in want]), rtol=RTOL, atol=ATOL)
    assert [r.label for r in got] == [r.label for r in want]
    for key in ("hits", "misses", "entries"):
        assert server.stats()["cache"][key] == jserver.stats()["cache"][key], key


def test_load_bundle_restores_the_saved_params(tiny, bundle):
    g, _ = tiny
    path, jparams = bundle
    ck = load_bundle(path, g, device="cpu")
    assert dataclasses.asdict(ck.model) == dataclasses.asdict(JFedGATConfig())
    assert ck.meta["num_clients"] == 2 and ck.meta["step"] == 2
    assert isinstance(ck.privacy, dict) and ck.privacy
    for layer, jlayer in zip(ck.params, jparams):
        for k in ("W", "a1", "a2"):
            np.testing.assert_array_equal(layer[k].detach().numpy(), np.asarray(jlayer[k]))


def test_load_bundle_rejects_a_graph_of_other_dims(bundle):
    path, _ = bundle
    other = make_cora_like("cora_like", seed=0)
    with pytest.raises(ValueError, match="shape"):
        load_bundle(path, other, device="cpu")


def test_port_serves_the_reference_default_matrix_bundle(tiny, bundle):
    """The bundle says ``FedGATConfig()``: engine ``matrix``, served as it
    stands by both servers (each builds its own packs)."""
    g, jg = tiny
    path, _ = bundle
    server = GraphInferenceServer.from_checkpoint(path, g, device="cpu")
    jserver = JServer.from_checkpoint(path, jg)
    assert server.cfg.engine == jserver.cfg.engine == "matrix"
    qs = [(c, n) for c in (0, 1) for n in range(g.num_nodes)]
    got = server.serve_batch([Query(c, n) for c, n in qs])
    want = jserver.serve_batch([JQuery(c, n) for c, n in qs])
    np.testing.assert_allclose(np.stack([r.logits for r in got]),
                               np.stack([r.logits for r in want]), rtol=1e-3, atol=1e-4)
    assert [r.label for r in got] == [r.label for r in want]
    for key in ("hits", "misses", "entries"):
        assert server.stats()["cache"][key] == jserver.stats()["cache"][key], key
    with pytest.raises(UnknownEngineError, match="registered engines"):
        GraphInferenceServer.from_checkpoint(path, g, engine="sparse", device="cpu")


def test_distgat_without_a_partition_raises(tiny, bundle):
    g, _ = tiny
    path, _ = bundle
    ck = load_bundle(path, g, device="cpu")
    with pytest.raises(ValueError, match="needs the training Partition"):
        GraphInferenceServer(ck.params, ck.model, g, method="distgat", num_clients=2,
                             engine="exact", device="cpu")


def test_server_default_device_raises_without_cuda(tiny, bundle, monkeypatch):
    g, _ = tiny
    path, _ = bundle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphInferenceServer.from_checkpoint(path, g, engine="kernel", device=None)
    ck = load_bundle(path, g, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GraphInferenceServer(ck.params, ck.model, g, engine="kernel")


def test_cpu_serving_launches_no_kernel(tiny, bundle):
    g, _ = tiny
    path, _ = bundle
    before = cheb_attn.launches
    server = GraphInferenceServer.from_checkpoint(path, g, engine="kernel", device="cpu")
    server.serve_batch([Query(0, 1), Query(1, 2)])
    assert cheb_attn.launches == before


def test_client_pack_key_is_deterministic_and_per_client():
    keys = {tuple(client_pack_key(0, c)) for c in range(64)}
    assert len(keys) == 64
    np.testing.assert_array_equal(client_pack_key(3, 5), client_pack_key(3, 5))
    assert tuple(client_pack_key(1, 5)) != tuple(client_pack_key(3, 5))


def test_serve_cli_runs_a_jax_bundle_on_cpu(bundle, capsys):
    path, _ = bundle
    serve_cli.main(["--mode", "graph", "--ckpt", path, "--engine", "kernel",
                    "--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "engine=kernel" in out and "served: 48 queries" in out
    assert "post-update: served 4" in out and "cache: entries=2" in out


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n.startswith('jaxlib') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "new = ['repro_torch.federated.trainer', 'repro_torch.federated.partition',\n"
        "       'repro_torch.federated.comm', 'repro_torch.federated.aggregation',\n"
        "       'repro_torch.optim.adamw', 'repro_torch.privacy.config',\n"
        "       'repro_torch.core.gcn', 'repro_torch.checkpoint.ckpt',\n"
        "       'repro_torch.kernels.flash_attn', 'repro_torch.kernels.poly_attn',\n"
        "       'repro_torch.kernels.wkv_chunk', 'repro_torch.kernels._launch',\n"
        "       'repro_torch.core.fedgat_matrix', 'repro_torch.core.fedgat_vector',\n"
        "       'repro_torch.analysis.error_bounds', 'repro_torch._rng',\n"
        "       'repro_torch.federated.cohort', 'repro_torch.privacy.accountant',\n"
        "       'repro_torch.privacy.dp', 'repro_torch.privacy.secure_agg',\n"
        "       'repro_torch.privacy.shamir', 'repro_torch.privacy.pack_dp',\n"
        "       'repro_torch.privacy.attacks.mia', 'repro_torch.federated.sharded',\n"
        "       'repro_torch.launch.multiprocess', 'repro_torch.telemetry.manifest',\n"
        "       'repro_torch.telemetry.tracing', 'repro_torch.telemetry.sink',\n"
        "       'repro_torch.configs', 'repro_torch.configs.yi_6b', 'repro_torch.models',\n"
        "       'repro_torch.models.transformer', 'repro_torch.models.encdec',\n"
        "       'repro_torch.models.moe', 'repro_torch.models.rwkv', 'repro_torch.models.hybrid',\n"
        "       'repro_torch.data.pipeline', 'repro_torch.optim.schedule',\n"
        "       'repro_torch.launch.train', 'repro_torch.launch.steps']\n"
        "assert all(n in sys.modules for n in new), new\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=root, env={**os.environ, "PYTHONPATH": str(root / "src")},
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 87
