"""The reference API that the port took over last: Theorem 2, the core
helpers, the dense GAT/GCN forms, the graph's dense view and
``build_neighbor_lists``, the metrics registry and telemetry's switches,
and the package exports, each against ``src/repro/`` on numpy-seeded
inputs.

Tolerances: numpy code (Theorem 2, ``normalized_adjacency``,
``build_neighbor_lists``) bit for bit; the dense GAT and GCN at the
reference's own 1e-5 (``tests/test_gat.py:33``,
``tests/test_bucketed_kernel.py:108``); ``moments_direct`` at rtol 1e-5 /
atol 1e-6 (powers of float32 scores summed in another order).
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import repro.core as jcore
import repro.graphs as jgraphs
import repro.kernels as jkernels
import repro.telemetry as jtelemetry
import repro.telemetry.metrics as jmetrics
from repro.core import chebyshev as jcheb
from repro.core import engine as jengine
from repro.core import gat as jgat
from repro.core import gcn as jgcn
from repro.core import poly_attention as jpoly
from repro_torch import core, graphs, kernels, telemetry
from repro_torch.core import chebyshev, gat, gcn, params_from_numpy, poly_attention
from repro_torch.core import engine as engine_mod
from repro_torch.telemetry import metrics

torch.set_num_threads(1)

CPU = torch.device("cpu")
DENSE_TOL = 1e-5                 # tests/test_gat.py:33, tests/test_bucketed_kernel.py:108
MOMENT_RTOL, MOMENT_ATOL = 1e-5, 1e-6
ROOT = pathlib.Path(__file__).resolve().parents[1]

# The reference's names that the port leaves out, and why.
LEFT_OUT = {
    # The TPU block model: the port's kernels pick tiles in ``launch_plan``.
    "select_block_sizes", "resolve_interpret", "clear_block_cache",
    # ``cheb_attn`` is an ``autograd.Function`` itself.
    "cheb_attn_diff",
    # XLA's compile accounting; the manifest counts kernel builds instead, and
    # the metrics registry has no ``jax.jit_compiles`` gauge.
    "install_jax_hooks", "jit_compile_count", "jit_compile_seconds", "jax.jit_compiles",
    # The serving engine's fallback: the port never falls back.
    "kernel_available", "resolve_serving_engine",
    # XLA's simulated host devices (``_compat/`` likewise has no counterpart).
    "force_host_device_count",
}


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jax_gat_params(seed, g, hidden=8, heads=4):
    params = jgat.init_gat_params(jax.random.PRNGKey(seed), g.feature_dim, hidden,
                                  g.num_classes, heads=heads)
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _jax_gcn_params(seed, g, hidden=16):
    params = jgcn.init_gcn_params(jax.random.PRNGKey(seed), g.feature_dim, hidden,
                                  g.num_classes)
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def graph_pair():
    return {name: (graphs.make_cora_like(name, seed=1), jgraphs.make_cora_like(name, seed=1))
            for name in ("tiny", "cora_like")}


# ---------------------------------------------------------------------------
# Theorem 2 and the core helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("V,k,p", [(1.0, 1, 2), (2.5, 1, 16), (3.0, 2, 9), (0.7, 3, 64)])
def test_theorem2_bound_is_the_reference_s(V, k, p):
    assert chebyshev.theorem2_bound(V, k, p) == jcheb.theorem2_bound(V, k, p)
    with pytest.raises(ValueError, match="p > k"):
        chebyshev.theorem2_bound(V, p, p)


@pytest.mark.parametrize("degree,domain", [(4, (-4.0, 4.0)), (16, (-4.0, 4.0)),
                                           (32, (-2.0, 2.0)), (9, (-1.0, 1.0))])
@pytest.mark.parametrize("fn", ["score", "exp"])
def test_empirical_sup_error_is_the_reference_s(degree, domain, fn):
    f = chebyshev.default_score_fn if fn == "score" else np.exp
    jf = jcheb.default_score_fn if fn == "score" else np.exp
    cc = chebyshev.chebyshev_coeffs(f, degree, domain)
    np.testing.assert_array_equal(cc, jcheb.chebyshev_coeffs(jf, degree, domain))
    for num in (4001, 513):
        assert (chebyshev.empirical_sup_error(f, cc, domain, num)
                == jcheb.empirical_sup_error(jf, cc, domain, num))


@pytest.mark.parametrize("lead,b,d,max_n", [((), 5, 3, 0), ((7,), 8, 4, 6),
                                            ((3, 11), 16, 5, 16)])
@pytest.mark.parametrize("seed", [0, 1])
def test_moments_direct_matches_the_reference(lead, b, d, max_n, seed):
    """Scores in [-1, 1], as layer 1's are (|x| < 0.26 on ``tiny`` at the
    reference's init, below)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, lead + (b,)).astype(np.float32)
    h = rng.standard_normal(lead + (b, d)).astype(np.float32)
    mask = rng.random(lead + (b,)) < 0.7
    E, F = poly_attention.moments_direct(_t(x), _t(h), _t(mask), max_n)
    jE, jF = jpoly.moments_direct(x, h, mask, max_n)
    assert E.shape == (max_n + 1,) + lead + (d,) and F.shape == (max_n + 1,) + lead
    _close(E, jE, MOMENT_RTOL, MOMENT_ATOL)
    _close(F, jF, MOMENT_RTOL, MOMENT_ATOL)


@pytest.mark.parametrize("name", ["tiny", "cora_like"])
@pytest.mark.parametrize("max_n", [5, 16])
def test_moments_direct_on_layer1_scores(graph_pair, name, max_n):
    """Eq. 8's moments of a graph's layer-1 edge scores at the reference's
    initial params (``tests/test_fedgat_engines.py:65`` takes max_n 5; 16
    is the paper's degree)."""
    g, jg = graph_pair[name]
    jp = _jax_gat_params(0, jg, heads=8)
    b1, b2 = jpoly.head_projections(jp[0])
    x = np.asarray(jpoly.edge_scores(b1, b2, jg.features, jg.nbr_idx))
    h_nb = jg.features[jg.nbr_idx]
    E, F = poly_attention.moments_direct(_t(x), _t(h_nb), _t(g.nbr_mask), max_n)
    jE, jF = jpoly.moments_direct(x, h_nb, jg.nbr_mask, max_n)
    _close(E, jE, MOMENT_RTOL, MOMENT_ATOL)
    _close(F, jF, MOMENT_RTOL, MOMENT_ATOL)


def test_unregister_engine_follows_the_reference():
    for mod in (engine_mod, jengine):
        before = mod.registered_engines()

        @mod.register_engine("_api_probe")
        class Probe(mod.Engine):
            pass

        assert "_api_probe" in mod.registered_engines()
        mod.unregister_engine("_api_probe")
        mod.unregister_engine("_api_probe")            # absent: a no-op
        assert mod.registered_engines() == before
        with pytest.raises(mod.UnknownEngineError):
            mod.get_engine("_api_probe")


# ---------------------------------------------------------------------------
# The dense forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "cora_like"])
@pytest.mark.parametrize("concat", [True, False])
def test_gat_layer_dense_matches_the_reference(graph_pair, name, concat):
    g, jg = graph_pair[name]
    jp = _jax_gat_params(0, jg)
    p = params_from_numpy(jp, device=CPU)
    out = gat.gat_layer_dense(p[0], _t(g.features), _t(g.adj), concat)
    want = jgat.gat_layer_dense(jp[0], jg.features, jg.adj, concat)
    _close(out, want, DENSE_TOL, DENSE_TOL)
    nbr = gat.gat_layer_nbr(p[0], _t(g.features), _t(g.nbr_idx).long(), _t(g.nbr_mask), concat)
    _close(out, nbr.detach().numpy(), DENSE_TOL, DENSE_TOL)


@pytest.mark.parametrize("name", ["tiny", "cora_like"])
@pytest.mark.parametrize("use_nbr", [False, True])
def test_gat_forward_matches_the_reference(graph_pair, name, use_nbr):
    g, jg = graph_pair[name]
    jp = _jax_gat_params(1, jg)
    p = params_from_numpy(jp, device=CPU)
    adj = None if use_nbr else _t(g.adj)
    out = gat.gat_forward(p, _t(g.features), adj, use_nbr=use_nbr,
                          nbr_idx=_t(g.nbr_idx).long(), nbr_mask=_t(g.nbr_mask))
    want = jgat.gat_forward(jp, jg.features, jg.adj, use_nbr=use_nbr,
                            nbr_idx=jg.nbr_idx, nbr_mask=jg.nbr_mask)
    assert out.shape == (g.num_nodes, g.num_classes)
    _close(out, want, DENSE_TOL, DENSE_TOL)


def test_gat_layer_dense_isolated_rows_aggregate_to_zero():
    rng = np.random.default_rng(0)
    h = rng.standard_normal((6, 4)).astype(np.float32)
    adj = rng.random((6, 6)) < 0.5
    adj[2] = False
    jp = [{k: np.asarray(v) for k, v in l.items()} for l in
          jgat.init_gat_params(jax.random.PRNGKey(3), 4, 3, 2, heads=2)]
    p = params_from_numpy(jp, device=CPU)
    out = gat.gat_layer_dense(p[0], _t(h), _t(adj), True)
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    _close(out, jgat.gat_layer_dense(jp[0], h, adj, True), DENSE_TOL, DENSE_TOL)


@pytest.mark.parametrize("name", ["tiny", "cora_like"])
def test_normalized_adjacency_and_gcn_forward_match_the_reference(graph_pair, name):
    g, jg = graph_pair[name]
    a = gcn.normalized_adjacency(g.adj)
    np.testing.assert_array_equal(a, jgcn.normalized_adjacency(jg.adj))
    jp = _jax_gcn_params(2, jg)
    p = params_from_numpy(jp, device=CPU)
    h = _t(g.features)
    out = gcn.gcn_forward(p, h, _t(a))
    _close(out, jgcn.gcn_forward(jp, jg.features, a), DENSE_TOL, DENSE_TOL)
    coef = _t(gcn.normalized_nbr_coeffs(g.nbr_idx, g.nbr_mask))
    nbr = gcn.gcn_forward_nbr(p, h, _t(g.nbr_idx).long(), coef)
    _close(nbr, out.detach().numpy(), 0.0, DENSE_TOL)


# ---------------------------------------------------------------------------
# The graph's dense view and build_neighbor_lists
# ---------------------------------------------------------------------------

def _random_adjacency(seed, n):
    rng = np.random.default_rng(seed)
    upper = np.triu(rng.random((n, n)) < 0.15, k=1)
    adj = upper | upper.T
    np.fill_diagonal(adj, True)
    return adj


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("pad_multiple,max_degree", [(8, None), (4, None), (8, 5)])
def test_build_neighbor_lists_is_the_reference_s(seed, pad_multiple, max_degree):
    n = 37 + 5 * seed
    adj = _random_adjacency(seed, n)
    got = graphs.build_neighbor_lists(adj, pad_multiple, max_degree)
    want = jgraphs.build_neighbor_lists(adj, pad_multiple, max_degree)
    rows, cols = np.nonzero(np.triu(adj, k=1))
    edges = np.stack([rows, cols], axis=1)
    got_e = graphs.build_neighbor_lists(edges, pad_multiple, max_degree, num_nodes=n)
    want_e = jgraphs.build_neighbor_lists(edges, pad_multiple, max_degree, num_nodes=n)
    for a, b in ((got, want), (got_e, want_e), (got_e, got)):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="square"):
        graphs.build_neighbor_lists(edges)


@pytest.mark.parametrize("name", ["tiny", "cora_like"])
def test_dense_view_and_edge_count_are_the_reference_s(graph_pair, name):
    g, jg = graph_pair[name]
    np.testing.assert_array_equal(g.adj, jg.adj)
    np.testing.assert_array_equal(graphs.dense_adjacency(g), jgraphs.dense_adjacency(jg))
    for loops in (False, True):
        assert (g.num_undirected_edges(include_self_loops=loops)
                == jg.num_undirected_edges(include_self_loops=loops))
    capped, jcapped = graphs.sample_neighbors(g, 4, seed=3), jgraphs.sample_neighbors(jg, 4, seed=3)
    assert capped.num_undirected_edges() == jcapped.num_undirected_edges()


def test_dense_view_counter_and_limit(monkeypatch):
    """As ``tests/test_csr_parity.py::test_dense_view_counter_and_limit``,
    with the counter read through the registry and the error's message."""
    g = graphs.make_cora_like("tiny")
    graphs.reset_dense_view_count()
    assert graphs.dense_view_count() == 0
    _ = g.adj
    _ = g.adj
    assert graphs.dense_view_count() == 2
    assert telemetry.counter("graphs.dense_view_count").value == 2
    assert graphs.graph.DENSE_ADJ_DEFAULT_MAX_NODES == jgraphs.graph.DENSE_ADJ_DEFAULT_MAX_NODES
    assert graphs.dense_adj_limit() == graphs.graph.DENSE_ADJ_DEFAULT_MAX_NODES
    monkeypatch.setenv("REPRO_DENSE_ADJ_MAX", "10")
    assert graphs.dense_adj_limit() == jgraphs.dense_adj_limit() == 10
    with pytest.raises(graphs.DenseAdjacencyError) as err:
        _ = g.adj
    with pytest.raises(jgraphs.DenseAdjacencyError) as jerr:
        jgraphs.dense_adjacency(jgraphs.make_cora_like("tiny"))
    assert str(err.value) == str(jerr.value)
    assert isinstance(err.value, MemoryError)
    assert graphs.dense_view_count() == 2
    for bad in ("0", "-3", "many"):
        monkeypatch.setenv("REPRO_DENSE_ADJ_MAX", bad)
        with pytest.raises(ValueError) as err:
            graphs.dense_adj_limit()
        with pytest.raises(ValueError) as jerr:
            jgraphs.dense_adj_limit()
        assert str(err.value) == str(jerr.value)
    graphs.reset_dense_view_count()
    assert graphs.dense_view_count() == 0


def test_graph_paths_take_no_dense_view():
    """The CSR/neighbour-list paths (build, sampling, subgraphs, the
    neighbour-list forward) never materialise the dense view."""
    graphs.reset_dense_view_count()
    g = graphs.make_sbm("sbm_1k", seed=0)
    sub = graphs.subgraph(graphs.sample_neighbors(g, 8, seed=1), np.arange(100))
    p = core.init_params(torch.Generator().manual_seed(0), g.feature_dim, g.num_classes,
                         core.FedGATConfig(), device=CPU)
    gat.gat_forward(p, _t(sub.features), None, use_nbr=True,
                    nbr_idx=_t(sub.nbr_idx).long(), nbr_mask=_t(sub.nbr_mask))
    assert graphs.dense_view_count() == 0


# ---------------------------------------------------------------------------
# The metrics registry and telemetry's switches
# ---------------------------------------------------------------------------

def test_registry_kind_conflict_raises():
    """``tests/test_telemetry.py::test_registry_kind_conflict_raises`` on the
    port, and the same message as the reference's."""
    for mod in (metrics, jmetrics):
        reg = mod.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError) as err:
            reg.gauge("x")
        assert str(err.value) == "metric 'x' is a Counter, not a Gauge"
        assert isinstance(reg.counter("x"), mod.Counter)
        assert isinstance(reg.gauge("y"), mod.Gauge)
    assert metrics.registry() is metrics.registry()
    metrics.counter("api.probe_kind")
    with pytest.raises(TypeError):
        metrics.histogram("api.probe_kind")


def test_resets_and_histogram_kwargs_follow_the_reference():
    snaps = []
    for mod in (metrics, jmetrics):
        reg = mod.MetricsRegistry()
        c, gg = reg.counter("c"), reg.gauge("g")
        h = reg.histogram("h", lo=1e-3, hi=1e3, growth=1.05)
        c.inc(3)
        gg.set(2.5)
        for v in (0.5, 1.5, 7.0, 2e3):
            h.observe(v)
        assert reg.histogram("h") is h          # get: the kwargs of the first call stay
        snaps.append(reg.snapshot())
        c.reset()
        gg.reset()
        assert c.value == 0 and gg.value is None
        reg.counter("c").inc()
        reg.reset()
        assert c.value == 0 and h.count == 0 and reg.snapshot()["h"] == {"type": "histogram",
                                                                          "count": 0}
    assert snaps[0] == snaps[1]
    assert metrics.histogram("api.kwargs", growth=1.2) is metrics.histogram("api.kwargs")


def test_configure_and_reset_metrics():
    try:
        telemetry.reset()                         # the no-argument call keeps working
        telemetry.configure(enabled=True)
        assert telemetry.enabled()
        with telemetry.span("api_probe"):
            telemetry.event("api.probe", x=1)
        assert [r.name for r in telemetry.records()] == ["api_probe"]
        c = telemetry.counter("api.reset_probe")
        c.inc(5)
        telemetry.reset()
        assert telemetry.records() == [] and telemetry.events() == [] and c.value == 5
        telemetry.reset(reset_metrics=True)
        assert c.value == 0
        telemetry.configure(enabled=False)
        assert not telemetry.enabled()
    finally:
        telemetry.disable()
        telemetry.reset()


def _telemetry_probe(env, tmp_path):
    code = ("from repro_torch import telemetry\n"
            "with telemetry.span('probe'):\n    pass\n"
            "print(telemetry.enabled(), len(telemetry.records()))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=tmp_path, env={**{k: v for k, v in os.environ.items()
                              if not k.startswith("REPRO_TELEMETRY")},
                           "PYTHONPATH": str(ROOT / "src"), **env},
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.split()


@pytest.mark.parametrize("value,on", [("1", True), ("yes", True), ("ON", True),
                                      ("0", False), ("", False)])
def test_env_activation_at_import(tmp_path, value, on):
    out = tmp_path / "run"
    got = _telemetry_probe({"REPRO_TELEMETRY": value, "REPRO_TELEMETRY_DIR": str(out)},
                           tmp_path)
    assert got == ([str(on), "1"] if on else [str(on), "0"])
    written = sorted(p.name for p in out.glob("*")) if out.exists() else []
    assert written == (["events.jsonl", "manifest.json", "metrics.json", "trace.json"]
                       if on else [])


# ---------------------------------------------------------------------------
# Package exports
# ---------------------------------------------------------------------------

def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")
                 and getattr(vars(mod)[n], "__module__", mod.__name__).startswith("repro")]
    return set(names)


@pytest.mark.parametrize("ref,port", [
    (jcore, core), (jgraphs, graphs), (jkernels, kernels),
    (jtelemetry, telemetry), (jmetrics, metrics),
])
def test_every_public_name_of_the_reference_is_ported(ref, port):
    missing = sorted(n for n in _public(ref) - LEFT_OUT if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"
    assert _public(ref) & LEFT_OUT <= {n for n in LEFT_OUT if not hasattr(port, n)}


@pytest.mark.parametrize("module", ["serving.server", "launch.multiprocess", "kernels.ops",
                                    "kernels", "telemetry"])
def test_left_out_names_stay_out(module):
    import importlib

    ref = importlib.import_module(f"repro.{module}")
    port = importlib.import_module(f"repro_torch.{module}")
    here = {n for n in LEFT_OUT if hasattr(ref, n)}
    assert here and not any(hasattr(port, n) for n in here)


def test_package_exports_are_the_functions():
    import importlib

    from repro_torch.kernels import ops

    assert graphs.__all__ == jgraphs.__all__
    assert kernels.cheb_attn is importlib.import_module("repro_torch.kernels.cheb_attn").cheb_attn
    assert kernels.cheb_attn_layer is ops.cheb_attn_layer
    assert core.chebyshev is chebyshev and core.moments_direct is poly_attention.moments_direct
    assert core.gat_forward is gat.gat_forward and core.gcn_forward is gcn.gcn_forward
    for extra in ("layered_forward", "params_from_numpy", "pack_from_numpy"):
        assert extra in core.__all__ and hasattr(core, extra)
    assert set(metrics.__all__) == set(jmetrics.__all__)
