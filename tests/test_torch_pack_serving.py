"""The server's pack lifecycle against the JAX package: the pack build on a
miss, patches, coverage, drift and refreshes on a graph delta, cache
persistence, distgat serving and the serve CLI, on a bundle the JAX
package's Trainer wrote with ``FedGATConfig()`` (engine ``matrix``).

The two servers draw their packs from different generators (the reference
folds the client into a JAX key; the port seeds a ``torch.Generator`` by
splitmix64), so their logits agree at the engine's tolerance. Drift is
deterministic — it depends on params, coefficients, graph and coverage,
not on any draw — so eps is held at rtol 1e-4 and the refreshed clients
must be the same.
"""
import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

from repro.core import FedGATConfig as JFedGATConfig
from repro.federated.partition import dirichlet_partition as j_dirichlet_partition
from repro.federated.trainer import FederatedConfig, Trainer
from repro.graphs import make_cora_like as j_make_cora_like
from repro.serving import GraphDelta as JGraphDelta
from repro.serving import GraphInferenceServer as JServer
from repro.serving import PackCache as JPackCache
from repro.serving import Query as JQuery
from repro.serving import apply_delta as j_apply_delta
from repro.serving import updates as jupdates
from repro.serving import save_bundle
from repro_torch import telemetry
from repro_torch.core import FedGATPack, VectorPack, get_engine, layered_forward, pack_from_numpy
from repro_torch.core.fedgat_model import graph_tensors
from repro_torch.federated.partition import client_neighbor_masks, dirichlet_partition
from repro_torch.graphs import make_cora_like
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import (
    GraphDelta,
    GraphInferenceServer,
    PackCache,
    Query,
    apply_delta,
    concat_pack_rows,
    coverage_lookup,
    extend_coverage,
    initial_coverage,
    load_bundle,
    mass_drift,
    patch_pack,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = {"matrix": (1e-3, 1e-4), "vector": (1e-4, 1e-5),      # tests/test_fedgat_engines.py:110,121
       "direct": (1e-4, 1e-5), "exact": (1e-4, 1e-5)}
EPS_RTOL = 1e-4


@pytest.fixture(scope="module")
def tiny():
    return make_cora_like("tiny", seed=0), j_make_cora_like("tiny", seed=0)


@pytest.fixture(scope="module")
def bundle(tiny, tmp_path_factory):
    """One JAX-trained bundle for the whole file: ``FedGATConfig()``, whose
    engine is ``matrix``, over 2 clients."""
    cfg = FederatedConfig(method="fedgat", num_clients=2, rounds=2, local_steps=1, seed=0,
                          model=JFedGATConfig())
    res = Trainer(cfg).run(tiny[1])
    path = tmp_path_factory.mktemp("bundle") / "ckpt"
    save_bundle(str(path), res["params"], cfg, step=2)
    return str(path)


def _delta(g, m=3, seed=1, owners=False):
    """m new nodes (features copied from old ones plus noise), an edge from
    each to an old node, and two old-old edges: old rows go stale."""
    rng = np.random.default_rng(seed)
    feats = g.features[rng.integers(0, g.num_nodes, size=m)]
    feats = feats + 0.01 * rng.standard_normal(feats.shape).astype(np.float32)
    n_new = g.num_nodes + m
    edges = np.concatenate([
        np.stack([np.arange(g.num_nodes, n_new), rng.integers(0, g.num_nodes, size=m)], axis=1),
        np.array([[0, 7], [3, 11]]),
    ])
    own = rng.integers(0, 2, size=m) if owners else None
    return GraphDelta(features=feats, edges=edges, owners=own), \
        JGraphDelta(features=feats, edges=edges, owners=own)


def _servers(tiny, bundle, **kw):
    g, jg = tiny
    return (GraphInferenceServer.from_checkpoint(bundle, g, device="cpu", **kw),
            JServer.from_checkpoint(bundle, jg, **kw))


def _queries(n, clients=(0, 1)):
    return [(c, v) for c in clients for v in range(n)]


def _serve_both(server, jserver, pairs):
    got = server.serve_batch([Query(c, v) for c, v in pairs])
    want = jserver.serve_batch([JQuery(c, v) for c, v in pairs])
    return np.stack([r.logits for r in got]), np.stack([r.logits for r in want]), got, want


def _assert_same_answers(server, jserver, pairs, tol):
    a, b, got, want = _serve_both(server, jserver, pairs)
    np.testing.assert_allclose(a, b, rtol=tol[0], atol=tol[1])
    assert [r.label for r in got] == [r.label for r in want]


# ---------------------------------------------------------------------------
# Coverage, the patch and the drift, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("visible", [False, True])
def test_coverage_matches_reference(tiny, visible):
    g, jg = tiny
    delta, jdelta = _delta(g)
    part = dirichlet_partition(g.labels, 2, 1.0, 0)
    vis = client_neighbor_masks(g, part, clients=[1])[0] if visible else None
    cov, jcov = initial_coverage(g, vis), jupdates.initial_coverage(jg, vis)
    np.testing.assert_array_equal(cov.keys, jcov.keys)
    assert cov.num_nodes == jcov.num_nodes and cov.num_covered == jcov.num_covered
    new, jnew = apply_delta(g, delta), j_apply_delta(jg, jdelta)
    part2 = part._replace(owner=np.concatenate([part.owner, np.ones(3, part.owner.dtype)]))
    vis2 = client_neighbor_masks(new, part2, clients=[1])[0] if visible else None
    for b_pack in (g.max_degree, 2):
        ext, jext = extend_coverage(cov, new, b_pack, vis2), jupdates.extend_coverage(
            jcov, jnew, b_pack, vis2)
        np.testing.assert_array_equal(ext.keys, jext.keys)
        np.testing.assert_array_equal(coverage_lookup(ext, new.nbr_idx),
                                      jupdates.coverage_lookup(jext, jnew.nbr_idx))
    empty = cov._replace(keys=np.zeros(0, np.int64))
    assert not coverage_lookup(empty, g.nbr_idx).any()


@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_patch_pack_and_mass_drift_match_reference(tiny, bundle, engine):
    """The reference's pack carried across, patched by each package, served
    through each package's layer on the grown graph; the coverage and the
    drift of the stale pack."""
    import jax
    import jax.numpy as jnp

    from repro.core.engine import get_engine as j_get_engine
    from repro.core.fedgat_model import layered_forward as j_layered_forward

    g, jg = tiny
    ck = load_bundle(bundle, g, device="cpu")
    cfg = dataclasses.replace(ck.model, engine=engine)
    jcfg = JFedGATConfig(**dataclasses.asdict(cfg))
    jengine, tengine = j_get_engine(engine)(jcfg), get_engine(engine)(cfg)
    jpack = jengine.precompute(jax.random.PRNGKey(3), jnp.asarray(jg.features),
                               jnp.asarray(jg.nbr_idx), jnp.asarray(jg.nbr_mask))
    pack = pack_from_numpy(jpack, device=CPU)
    delta, jdelta = _delta(g)
    new, jnew = apply_delta(g, delta), j_apply_delta(jg, jdelta)
    patched = patch_pack(tengine, torch.Generator().manual_seed(0), pack, g.num_nodes, new,
                         g.max_degree)
    jpatched = jupdates.patch_pack(jengine, jax.random.PRNGKey(4), jpack, g.num_nodes, jnew,
                                   jg.max_degree)
    assert type(patched) is type(pack)
    for a, b, old in zip(patched, jpatched, pack):
        if isinstance(a, torch.Tensor):
            assert tuple(a.shape) == b.shape and a.shape[0] == new.num_nodes
            assert torch.equal(a[:g.num_nodes], old)              # old rows untouched: stale
        else:
            assert a == b == old
    coeffs = torch.as_tensor(cfg.coeffs(), dtype=torch.float32)
    jparams = [{k: jnp.asarray(v.detach().numpy()) for k, v in layer.items()} for layer in ck.params]
    out = layered_forward(tengine, ck.params, coeffs, patched, *graph_tensors(new, CPU))
    want = j_layered_forward(jengine, jparams, jnp.asarray(jcfg.coeffs(), jnp.float32), jpatched,
                             jnp.asarray(jnew.features), jnp.asarray(jnew.nbr_idx),
                             jnp.asarray(jnew.nbr_mask))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), *TOL[engine])
    cov = extend_coverage(initial_coverage(g), new, g.max_degree)
    eps = mass_drift(ck.params[0], coeffs, cfg.basis, cfg.domain, new, cov)
    jeps = jupdates.mass_drift(jparams[0], jnp.asarray(jcfg.coeffs(), jnp.float32), jcfg.basis,
                               jcfg.domain, jnew, cov)
    assert eps > 0 and eps == pytest.approx(jeps, rel=EPS_RTOL)
    assert mass_drift(ck.params[0], coeffs, cfg.basis, cfg.domain, g, initial_coverage(g)) == 0.0
    assert patch_pack(tengine, None, pack, g.num_nodes, g, g.max_degree) is pack
    assert patch_pack(tengine, None, None, g.num_nodes, new, g.max_degree) is None


def test_concat_pack_rows_keeps_r_and_checks_types():
    a = FedGATPack(*(torch.ones(2, 3) for _ in range(4)), r=1.7)
    b = FedGATPack(*(torch.zeros(1, 3) for _ in range(4)), r=9.0)
    c = concat_pack_rows(a, b)
    assert c.r == 1.7 and all(t.shape == (3, 3) for t in c[:4])
    assert torch.equal(c.P[2], torch.zeros(3))
    with pytest.raises(TypeError, match="mismatch"):
        concat_pack_rows(a, VectorPack(*(torch.zeros(1, 3) for _ in range(5))))


# ---------------------------------------------------------------------------
# The servers on the same delta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [2.0, 1e-9, 1e9])
@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_servers_agree_on_drift_refreshes_and_answers(tiny, bundle, engine, threshold):
    g, _ = tiny
    server, jserver = _servers(tiny, bundle, engine=engine, refresh_threshold=threshold)
    assert server.cfg.engine == jserver.cfg.engine == engine
    _assert_same_answers(server, jserver, _queries(g.num_nodes), TOL[engine])
    delta, jdelta = _delta(g)
    rep, jrep = server.apply_update(delta), jserver.apply_update(jdelta)
    assert rep["refreshed"] == jrep["refreshed"]
    assert sorted(rep["drift"]) == sorted(jrep["drift"]) == [0, 1]
    for c in (0, 1):
        assert rep["drift"][c] > 0
        assert rep["drift"][c] == pytest.approx(jrep["drift"][c], rel=EPS_RTOL)
        np.testing.assert_array_equal(server._clients[c].covered.keys,
                                      jserver._clients[c].covered.keys)
        d, jd = server.drift(c), jserver.drift(c)
        assert set(d) == set(jd)
        assert d["bound"] == pytest.approx(jd["bound"], rel=EPS_RTOL)
        assert (d["patches"], d["refreshes"], d["threshold"]) == (
            jd["patches"], jd["refreshes"], jd["threshold"])
    # Every node of the grown graph, stale rows and new ones.
    _assert_same_answers(server, jserver, _queries(g.num_nodes + 3), TOL[engine])
    for key in ("entries", "hits", "misses", "patches", "refreshes", "evictions"):
        assert server.stats()["cache"][key] == jserver.stats()["cache"][key], key
    assert server.stats()["cache"]["patches"] == 2
    if threshold == 1e-9:
        assert rep["refreshed"] == [0, 1]
    if threshold == 1e9:
        assert rep["refreshed"] == []


def test_the_drift_tracks_the_thm35_bound_and_refreshes_when_crossed(tiny, bundle):
    g, _ = tiny
    server, _ = _servers(tiny, bundle)
    server.serve_batch([Query(0, 1), Query(1, 2)])
    rep = server.apply_update(_delta(g)[0])
    st = server.drift(0)
    from repro_torch.analysis.error_bounds import thm35_logit_bound

    eps = rep["drift"][0]
    assert st["history"] == [eps]
    crossed = thm35_logit_bound(eps, server.cfg.num_layers, server.cfg.heads) > 2.0
    assert (0 in rep["refreshed"]) == crossed
    if crossed:
        assert st["eps"] == 0.0 and st["refreshes"] == 1
    assert st["patches"] == 1


def test_refresh_rebuilds_bit_for_bit_and_clears_the_drift(tiny, bundle):
    g, _ = tiny
    server, _ = _servers(tiny, bundle, refresh_threshold=1e9)
    direct, _ = _servers(tiny, bundle, engine="direct")
    server.serve_batch([Query(0, 0)])
    delta = _delta(g)[0]
    server.apply_update(delta)
    direct.apply_update(delta)
    assert server.drift(0)["eps"] > 0 and server.cache.peek(0).patched
    server.refresh(0)
    assert server.drift(0)["eps"] == 0.0 and not server.cache.peek(0).patched
    assert server.cache.peek(0).builds == 2
    fresh = server.engine.precompute(server._client_gen(0), server._h, server._idx, server._mask)
    for a, b in zip(server.pack_for(0), fresh):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    pairs = [Query(0, v) for v in range(g.num_nodes + 3)]
    got = np.stack([r.logits for r in server.serve_batch(pairs)])
    want = np.stack([r.logits for r in direct.serve_batch(pairs)])
    np.testing.assert_allclose(got, want, *TOL["matrix"])


def test_pack_free_engines_absorb_deltas_exactly(tiny, bundle):
    g, _ = tiny
    server, jserver = _servers(tiny, bundle, engine="direct")
    _assert_same_answers(server, jserver, _queries(g.num_nodes), TOL["direct"])
    delta, jdelta = _delta(g)
    rep, jrep = server.apply_update(delta), jserver.apply_update(jdelta)
    assert rep["drift"] == jrep["drift"] == {0: 0.0, 1: 0.0} and rep["refreshed"] == []
    _assert_same_answers(server, jserver, _queries(g.num_nodes + 3), TOL["direct"])
    assert server.stats()["cache"] == jserver.stats()["cache"]
    assert server.pack_for(0) is None


def test_an_evicted_client_is_dropped_and_rebuilt(tiny, bundle):
    g, _ = tiny
    server, jserver = _servers(tiny, bundle, cache=None)
    server.cache.capacity = jserver.cache.capacity = 1
    _assert_same_answers(server, jserver, _queries(4), TOL["matrix"])
    delta, jdelta = _delta(g)
    rep, jrep = server.apply_update(delta), jserver.apply_update(jdelta)
    assert sorted(rep["drift"]) == sorted(jrep["drift"]) == [1]
    _assert_same_answers(server, jserver, _queries(g.num_nodes + 3), TOL["matrix"])
    assert server.stats()["cache"] == jserver.stats()["cache"]


def test_pack_builds_are_traced_when_telemetry_is_on(tiny, bundle):
    server, _ = _servers(tiny, bundle)
    telemetry.reset()
    telemetry.enable()
    try:
        server.serve_batch([Query(0, 1), Query(1, 1), Query(0, 2)])
    finally:
        telemetry.disable()
    records = telemetry.records()
    telemetry.reset()
    builds = [r.args["client"] for r in records if r.name == "serving.pack_build"]
    assert sorted(builds) == [0, 1]
    assert [r.name for r in records].count("serving.client_forward") == 2


def test_refresh_threshold_must_be_positive(tiny, bundle):
    g, _ = tiny
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="refresh_threshold"):
            GraphInferenceServer.from_checkpoint(bundle, g, device="cpu", refresh_threshold=bad)


# ---------------------------------------------------------------------------
# Persistence
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_save_and_load_round_trip_warm_starts_a_server(tiny, bundle, tmp_path, engine):
    g, _ = tiny
    server, _ = _servers(tiny, bundle, engine=engine)
    pairs = [Query(c, v) for c in (0, 1) for v in range(g.num_nodes)]
    before = np.stack([r.logits for r in server.serve_batch(pairs)])
    server.apply_update(_delta(g)[0])
    with pytest.raises(ValueError, match="no cache directory"):
        server.save_cache()
    index = server.save_cache(str(tmp_path))
    assert [e["client"] for e in index["entries"]] == [0, 1]
    loaded = PackCache.load(str(tmp_path), device="cpu")
    assert loaded.stats() == server.cache.stats()
    for c in (0, 1):
        a, b = loaded.peek(c), server.cache.peek(c)
        assert (a.fingerprint, a.patched, a.builds) == (b.fingerprint, b.patched, b.builds)
        assert type(a.pack) is type(b.pack)
        for x, y in zip(a.pack, b.pack):
            assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    warm = GraphInferenceServer.from_checkpoint(bundle, server.graph, device="cpu",
                                                engine=engine, cache_dir=str(tmp_path))
    hits = warm.cache.hits
    got = np.stack([r.logits for r in warm.serve_batch(pairs)])
    assert warm.cache.hits > hits and warm.cache.misses == loaded.misses     # no rebuild
    want = np.stack([r.logits for r in server.serve_batch(pairs)])
    np.testing.assert_array_equal(got, want)
    assert before.shape == got.shape
    warm.save_cache()                                   # back to its cache_dir
    assert PackCache.load(str(tmp_path), device="cpu").hits == warm.cache.hits
    cold = GraphInferenceServer.from_checkpoint(bundle, g, device="cpu", engine=engine,
                                                cache_dir=str(tmp_path))
    cold.serve_batch([Query(0, 0)])                     # another graph: an ordinary miss
    assert cold.cache.misses == loaded.misses + 1


def test_a_tampered_payload_raises(tiny, bundle, tmp_path):
    server, _ = _servers(tiny, bundle)
    server.serve_batch([Query(0, 0)])
    server.save_cache(str(tmp_path))
    path = tmp_path / "pack_00000.npz"
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["K1"] = arrays["K1"] + 1e-3
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="digest"):
        PackCache.load(str(tmp_path), device="cpu")


def test_load_resolves_pack_types_by_name_and_imports_nothing(tiny, bundle, tmp_path):
    server, _ = _servers(tiny, bundle)
    server.serve_batch([Query(0, 0)])
    server.save_cache(str(tmp_path))
    index_path = tmp_path / "cache_index.json"
    index = json.loads(index_path.read_text())
    assert index["entries"][0]["payload"]["type"] == "repro_torch.core.fedgat_matrix:FedGATPack"
    index["entries"][0]["payload"]["type"] = "pack_loader_probe:FedGATPack"
    index_path.write_text(json.dumps(index))
    assert isinstance(PackCache.load(str(tmp_path), device="cpu").peek(0).pack, FedGATPack)
    assert "pack_loader_probe" not in sys.modules
    index["entries"][0]["payload"]["type"] = "repro.core.fedgat_matrix:Shape"
    index_path.write_text(json.dumps(index))
    with pytest.raises(ValueError, match="not one of the port's pack types"):
        PackCache.load(str(tmp_path), device="cpu")
    index["version"] = 99
    index_path.write_text(json.dumps(index))
    with pytest.raises(ValueError, match="format version"):
        PackCache.load(str(tmp_path), device="cpu")


@pytest.mark.parametrize("engine", ["matrix", "vector"])
def test_a_cache_the_reference_saved_loads_in_the_port(tiny, bundle, tmp_path, engine):
    g, _ = tiny
    _, jserver = _servers(tiny, bundle, engine=engine)
    pairs = _queries(g.num_nodes)
    want = np.stack([r.logits for r in jserver.serve_batch([JQuery(c, v) for c, v in pairs])])
    jserver.save_cache(str(tmp_path))
    cache = PackCache.load(str(tmp_path), device="cpu")
    jcache = JPackCache.load(str(tmp_path))
    assert cache.stats() == jcache.stats()
    server = GraphInferenceServer.from_checkpoint(bundle, g, device="cpu", engine=engine,
                                                  cache=cache)
    for c in (0, 1):
        pack = cache.peek(c).pack
        assert type(pack).__name__ == type(jcache.peek(c).pack).__name__
        for x, y in zip(pack, jcache.peek(c).pack):
            if isinstance(x, torch.Tensor):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            else:
                assert x == float(y)
        out = layered_forward(server.engine, server.params, server.coeffs, pack,
                              server._h, server._idx, server._mask).detach().numpy()
        np.testing.assert_allclose(out, want[c * g.num_nodes:(c + 1) * g.num_nodes],
                                   *TOL[engine])


# ---------------------------------------------------------------------------
# distgat serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["exact", "matrix"])
def test_distgat_is_served_through_both_servers(tiny, bundle, engine):
    """Per-client edge visibility from the partition the bundle's (beta,
    seed) rebuild, before and after a delta whose new nodes have owners."""
    g, jg = tiny
    server, jserver = _servers(tiny, bundle, engine=engine, method="distgat")
    np.testing.assert_array_equal(server.part.owner, jserver.part.owner)
    np.testing.assert_array_equal(
        server.part.owner, j_dirichlet_partition(jg.labels, 2, 1.0, 0).owner)
    tol = TOL[engine]
    _assert_same_answers(server, jserver, _queries(g.num_nodes), tol)
    for c in (0, 1):
        vis = client_neighbor_masks(g, server.part, clients=[c])[0]
        want = layered_forward(server.engine, server.params, server.coeffs, server.pack_for(c),
                               server._h, server._idx, torch.as_tensor(vis)).detach().numpy()
        got = np.stack([r.logits for r in server.serve_batch(
            [Query(c, v) for v in range(g.num_nodes)])])
        np.testing.assert_array_equal(got, want)
    delta, jdelta = _delta(g, owners=True)
    with pytest.raises(ValueError, match="owners"):
        server.apply_update(delta._replace(owners=None))
    with pytest.raises(ValueError, match="length"):
        server.apply_update(delta._replace(owners=np.zeros(2, np.int32)))
    with pytest.raises(ValueError, match="client range"):
        server.apply_update(delta._replace(owners=np.array([0, 1, 2])))
    rep, jrep = server.apply_update(delta), jserver.apply_update(jdelta)
    assert rep["refreshed"] == jrep["refreshed"]
    for c in rep["drift"]:
        assert rep["drift"][c] == pytest.approx(jrep["drift"][c], rel=EPS_RTOL)
    np.testing.assert_array_equal(server.part.owner, jserver.part.owner)
    _assert_same_answers(server, jserver, _queries(g.num_nodes + 3), tol)


def test_distgat_partition_must_match_the_client_count(tiny, bundle):
    g, _ = tiny
    ck = load_bundle(bundle, g, device="cpu")
    with pytest.raises(ValueError, match="partition has 3 clients"):
        GraphInferenceServer(ck.params, ck.model, g, method="distgat", num_clients=2,
                             partition=dirichlet_partition(g.labels, 3, 1.0, 0), device="cpu")
    with pytest.raises(ValueError, match="not servable"):
        GraphInferenceServer(ck.params, ck.model, g, method="fedgcn", device="cpu")


# ---------------------------------------------------------------------------
# The serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_distgat_quick_trains_and_serves(capsys):
    serve_cli.main(["--mode", "graph", "--method", "distgat", "--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "trained: method=distgat engine=exact rounds=2" in out
    assert "serving: engine=exact method=distgat clients=2" in out
    assert "worst_eps=0.0000 refreshed=[]" in out
    assert "post-update: served 4" in out and "patches=0 refreshes=0" in out


def test_serve_cli_vector_engine_with_a_refresh_threshold(bundle, capsys):
    serve_cli.main(["--mode", "graph", "--ckpt", bundle, "--engine", "vector",
                    "--refresh-threshold", "1e-9", "--fast", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "serving: engine=vector method=fedgat clients=2" in out
    assert "refreshed=[0, 1]" in out and "patches=2 refreshes=2" in out


def test_serve_cli_serves_the_matrix_bundle_as_the_reference_does(bundle, capsys):
    serve_cli.main(["--mode", "graph", "--ckpt", bundle, "--fast", "--device", "cpu",
                    "--refresh-threshold", "1e9"])
    out = capsys.readouterr().out
    assert "serving: engine=matrix method=fedgat clients=2" in out
    assert "refreshed=[]" in out and "patches=2 refreshes=0" in out
    worst = float(out.split("worst_eps=")[1].split()[0])
    assert worst > 0
