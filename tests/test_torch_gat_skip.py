"""The GAT paper's inductive model in the port (``FedGATConfig(skip=True)``:
three layers, a learned skip across the hidden layer, averaged output
heads) against the plain reference ``tests/plain_gat_skip.py`` on seeded
random weights, on the CPU at a small size.

Tolerances. Both sides compute in float32 the same mathematics in other
orders of summation (the kernel engine's plain ``cheb_attn``, the
neighbour gathers, the GEMMs' blocking): they part by a few dozen units in
the last place of the largest value (about 1e-7 of it on these inputs), so
logits and gradients are held to 1e-5 of the largest. That is a hundred
times the measured gap and a thousand times below what the skip moves
(checked here); TF32 products would part by about 1e-3 (held on the card,
``tests/test_torch_cuda.py``). A round adds two Adam steps, whose step
divides each gradient component by its own size, so a small component
carries its relative rounding error into the change at the scale of
``lr``: each leaf's change is held by its norm, to ``ROUND_TOL`` of the
reference's, a hundred times the measured 2e-6 at most.
"""
import dataclasses

import numpy as np
import plain_gat_skip as plain
import pytest
import torch

from repro_torch._tree import tree_leaves
from repro_torch.core import FedGATConfig
from repro_torch.core.engine import get_engine
from repro_torch.core.fedgat_model import graph_tensors, init_params, layered_forward
from repro_torch.core.gat import elu, gat_layer_nbr, init_gat_layer, masked_cross_entropy
from repro_torch.federated import FederatedConfig, run_federated
from repro_torch.federated.partition import client_train_masks, dirichlet_partition
from repro_torch.graphs.graph import make_graph_from_edges
from repro_torch.telemetry import config_hash
from repro_torch.telemetry.manifest import reference_fields

torch.set_num_threads(1)

N, D, C = 60, 12, 5
SKIP = dict(skip=True, num_layers=3, heads=4, hidden=8, out_heads=6)
TOL = 1e-5                      # of the largest value; see the module's docstring
ROUND_TOL = 1e-4                # of each leaf's change, by norm
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((N, D)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    labels = rng.integers(0, C, N).astype(np.int32)
    train = rng.random(N) < 0.6
    return make_graph_from_edges(feats, labels, rng.integers(0, N, (150, 2)), train, ~train,
                                 ~train, C)


def params_of(cfg, seed=1):
    return [{k: v.detach() for k, v in layer.items()}
            for layer in init_params(torch.Generator().manual_seed(seed), D, C, cfg, device=CPU)]


def port_loss_and_grads(cfg, params, g):
    engine = get_engine(cfg.engine)(cfg)
    h, idx, mask = graph_tensors(g, CPU)
    coeffs = torch.as_tensor(cfg.coeffs(), dtype=torch.float32)
    leaves = [t.clone().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    tree = [{k: next(it) for k in layer} for layer in params]
    logits = layered_forward(engine, tree, coeffs, engine.precompute(None, h, idx, mask),
                             h, idx, mask)
    labels = torch.as_tensor(g.labels, dtype=torch.int64)
    loss = masked_cross_entropy(logits, labels, torch.as_tensor(g.train_mask))
    return logits.detach(), list(torch.autograd.grad(loss, leaves))


def plain_inputs(g):
    h, idx, mask = graph_tensors(g, CPU)
    q = torch.as_tensor(plain.attention_series(16), dtype=torch.float32)
    return h, idx, mask, q


def close(got, want):
    """Within TOL of the largest reference value."""
    scale = max(float(w.abs().max()) for w in want)
    return max(float((a - b).abs().max()) for a, b in zip(got, want)) <= TOL * scale


@pytest.mark.parametrize("engine,layer1", [("kernel", "poly"), ("exact", "exact")])
def test_logits_and_every_gradient_match_the_plain_reference(graph, engine, layer1):
    cfg = FedGATConfig(engine=engine, **SKIP)
    params = params_of(cfg)
    assert [list(layer) for layer in params] == [["W", "a1", "a2"], ["W", "a1", "a2", "P"],
                                                 ["W", "a1", "a2"]]
    logits, grads = port_loss_and_grads(cfg, params, graph)
    h, idx, mask, q = plain_inputs(graph)
    labels = torch.as_tensor(graph.labels, dtype=torch.int64)
    want = plain.forward(params, h, idx, mask, q, layer1=layer1)
    _, want_grads = plain.loss_and_grads(params, h, idx, mask, q, labels,
                                         torch.as_tensor(graph.train_mask), layer1=layer1)
    assert close([logits], [want])
    assert close(grads, want_grads)
    assert float(grads[6].abs().max()) > 0                # P's gradient
    # the comparison sees the skip: without it the reference parts by far more
    dropped = plain.forward(params, h, idx, mask, q, layer1=layer1, skip=False)
    assert not close([logits], [dropped])
    assert float((dropped - want).abs().max()) > 1e3 * TOL * float(want.abs().max())


def test_one_federated_round_matches_the_reference_round(graph):
    cfg = FedGATConfig(engine="kernel", **SKIP)
    params = params_of(cfg, seed=2)
    fed = FederatedConfig(num_clients=2, rounds=1, local_steps=2, lr=0.01, weight_decay=1e-3,
                          client_fraction=1.0, seed=3, model=cfg)
    got = [{k: v.detach() for k, v in layer.items()}
           for layer in run_federated(graph, fed, device=CPU, params=params)["params"]]
    owner = dirichlet_partition(graph.labels, 2, fed.beta, fed.seed)
    masks = [torch.as_tensor(m) for m in client_train_masks(graph, owner)]
    h, idx, mask, q = plain_inputs(graph)
    want = plain.fedavg_round(params, masks, h, idx, mask, q,
                              torch.as_tensor(graph.labels, dtype=torch.int64),
                              local_steps=2, lr=fed.lr, wd=fed.weight_decay)
    assert [list(layer) for layer in got] == [list(layer) for layer in want]
    p0 = tree_leaves(params)
    change = [a - b for a, b in zip(tree_leaves(got), p0)]
    want_change = [a - b for a, b in zip(tree_leaves(want), p0)]
    for a, b in zip(change, want_change):
        assert float(torch.linalg.vector_norm(a - b)) <= ROUND_TOL * float(
            torch.linalg.vector_norm(b))
    assert float(want_change[6].abs().max()) > 0           # P moved


@pytest.mark.parametrize("engine", ["direct", "matrix", "vector"])
def test_every_engine_trains_the_skip_model(graph, engine):
    """Layers l > 1 are the same behind every engine's layer 1, so the skip
    trains behind each."""
    cfg = FedGATConfig(engine=engine, **SKIP)
    params = params_of(cfg, seed=5)
    fed = FederatedConfig(num_clients=2, rounds=1, local_steps=1, seed=6, model=cfg)
    got = run_federated(graph, fed, device=CPU, params=params)["params"]
    assert list(got[1]) == ["W", "a1", "a2", "P"]
    assert torch.isfinite(got[1]["P"]).all() and not torch.equal(got[1]["P"].detach(),
                                                                  params[1]["P"])


def test_skip_needs_a_hidden_layer_after_the_first():
    with pytest.raises(ValueError, match="num_layers >= 3"):
        FedGATConfig(skip=True)
    with pytest.raises(ValueError, match="num_layers >= 3"):
        FedGATConfig(skip=True, num_layers=2, heads=4, hidden=256, out_heads=6)
    assert FedGATConfig(**SKIP).skip
    assert dataclasses.replace(FedGATConfig(**SKIP), engine="exact").skip
    # an ordinary field: ==, hash() and repr() see it
    plain = FedGATConfig(**dict(SKIP, skip=False))
    assert FedGATConfig(**SKIP) != plain and hash(FedGATConfig(**SKIP)) != hash(plain)
    assert "skip=True" in repr(FedGATConfig(**SKIP))


def test_params_that_disagree_with_the_config_raise(graph):
    """``layered_forward`` takes the skip from the config, and params with
    P where the config has none, or without it where the config asks for
    it, raise rather than run the other model."""
    skip_cfg, plain_cfg = FedGATConfig(engine="kernel", **SKIP), FedGATConfig(
        engine="kernel", **dict(SKIP, skip=False))
    h, idx, mask = graph_tensors(graph, CPU)
    coeffs = torch.as_tensor(skip_cfg.coeffs(), dtype=torch.float32)
    for cfg, params, word in ((plain_cfg, params_of(skip_cfg), "hold"),
                              (skip_cfg, params_of(plain_cfg), "lack")):
        with pytest.raises(ValueError, match=f"layer 1: .* params {word} it"):
            layered_forward(get_engine("kernel")(cfg), params, coeffs, None, h, idx, mask)


def test_skip_off_keeps_the_fields_the_hash_the_params_and_the_logits(graph):
    """``skip=False`` (the default) leaves the config's fields and hash, the
    params drawn and the logits bit for bit as they were without the skip."""
    cfg = FedGATConfig(num_layers=3, heads=4, hidden=8, out_heads=6, engine="kernel")
    fields = {k: v for k, v in dataclasses.asdict(cfg).items() if k != "skip"}
    assert reference_fields(cfg) == fields
    assert reference_fields(dataclasses.replace(cfg, skip=True)) == dict(fields, skip=True)
    assert config_hash(cfg) == config_hash(dataclasses.replace(cfg, skip=False))
    assert config_hash(cfg) != config_hash(dataclasses.replace(cfg, skip=True))
    gen = torch.Generator().manual_seed(1)
    before = [init_gat_layer(gen, di, do, hd) for hd, di, do in
              [(4, D, 8), (4, 32, 8), (6, 32, C)]]
    params = params_of(cfg)
    assert [list(layer) for layer in params] == [["W", "a1", "a2"]] * 3
    for a, b in zip(tree_leaves(params), [t.detach() for layer in before for t in layer.values()]):
        assert torch.equal(a, b)
    # P is drawn after its layer's a2: what comes before it is unchanged
    skip = params_of(FedGATConfig(engine="kernel", **SKIP))
    for a, b in zip(tree_leaves(skip)[:6], tree_leaves(params)[:6]):
        assert torch.equal(a, b)

    engine = get_engine("kernel")(cfg)
    h, idx, mask = graph_tensors(graph, CPU)
    coeffs = torch.as_tensor(cfg.coeffs(), dtype=torch.float32)
    x = elu(engine.apply(params[0], None, coeffs, h, idx, mask, concat=True))
    x = elu(gat_layer_nbr(params[1], x, idx, mask, concat=True))
    want = gat_layer_nbr(params[2], x, idx, mask, concat=False)
    assert torch.equal(layered_forward(engine, params, coeffs, None, h, idx, mask), want)


def test_a_skip_model_round_trips_through_a_bundle_and_a_checkpoint(graph, tmp_path):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.serving.checkpoint import load_bundle, save_bundle

    cfg = FedGATConfig(engine="kernel", **SKIP)
    params = params_of(cfg, seed=4)
    save_bundle(str(tmp_path / "bundle"), params, FederatedConfig(model=cfg), step=3)
    ck = load_bundle(str(tmp_path / "bundle"), graph, device=CPU)
    assert ck.model.skip and ck.model == cfg and ck.meta["model"]["skip"] is True
    assert [list(layer) for layer in ck.params] == [list(layer) for layer in params]
    for layer, want in zip(ck.params, params):
        assert all(torch.equal(layer[k].detach(), want[k]) for k in want)
    # a bundle without the skip's P does not load as a skip model
    save_bundle(str(tmp_path / "plain"), params_of(dataclasses.replace(cfg, skip=False)),
                FederatedConfig(model=cfg), step=3)
    with pytest.raises(KeyError, match="params/1/P"):
        load_bundle(str(tmp_path / "plain"), graph, device=CPU)

    save_checkpoint(str(tmp_path / "ckpt.npz"), {"params": params}, step=5)
    template = {"params": [{k: torch.zeros_like(v) for k, v in layer.items()}
                           for layer in params]}
    restored, step = load_checkpoint(str(tmp_path / "ckpt.npz"), template)
    assert step == 5
    for a, b in zip(tree_leaves(restored), tree_leaves(params)):
        assert torch.equal(a, b)
