"""The paper drivers' accuracy rows against the reference's, at their
``fast`` sweeps on ``tiny``: ``table1_accuracy`` here, ``fig2_clients`` in
``tests/test_torch_paper_sweeps_clients.py``, ``fig5_degree`` and
``fig6_vector`` in ``tests/test_torch_paper_sweeps_degree_vector.py`` (one
file a driver or two, so that each stays near a minute on one CPU thread).

Torch cannot draw ``jax.random``'s bits, so the port's drivers start here
from the reference's own initial params and packs: the drivers' view of
``Trainer`` and ``train_centralized`` (``repro_torch.federated``, which a
driver reads when it runs) is replaced by one that draws them as the
reference's ``_run_vmap`` and ``train_centralized`` do
(``k_pack, k_init = split(PRNGKey(seed))``,
``src/repro/federated/trainer.py:455-456,593``) and passes them to the
port's ``Trainer.run(g, params=, pack=)`` and ``train_centralized(...,
params=, pack=)``. Every accuracy is then held to the reference's within
one test node (1 / the test split's size); every other column exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

import repro.federated.trainer as jtrainer
import repro_torch.federated
from benchmarks import table1_accuracy as j_table1
from benchmarks_torch import table1_accuracy
from repro.core import FedGATConfig as JFedGATConfig
from repro.core.fedgat_model import FedGAT as JFedGAT
from repro.core.gcn import init_gcn_params as j_init_gcn_params
from repro.graphs import Graph as JGraph
from repro_torch.federated import trainer
from repro_torch.graphs import make_cora_like
from repro_torch.telemetry.manifest import reference_fields

torch.set_num_threads(1)

CPU = torch.device("cpu")
ACC_KEYS = ("acc", "std")
TEST_NODES = int(make_cora_like("tiny", seed=0).test_mask.sum())


def _numpy_tree(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _reference_cfg(cfg):
    """The reference's FederatedConfig with the port's field values."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name not in ("model", "privacy")}
    return jtrainer.FederatedConfig(model=JFedGATConfig(**reference_fields(cfg.model)), **kw)


class _FromReference(trainer.Trainer):
    """The port's Trainer, started from the reference's initial params and
    pack for the same config and graph."""

    def run(self, g, params=None, pack=None):
        jcfg, jg = _reference_cfg(self.cfg), JGraph(*g)
        k_pack, k_init = jax.random.split(jax.random.PRNGKey(jcfg.seed))
        if jcfg.method == "fedgcn":
            params = j_init_gcn_params(k_init, jg.feature_dim, jcfg.gcn_hidden, jg.num_classes)
        else:
            model = JFedGAT(jtrainer.method_model_config(jcfg))
            pack = model.precommunicate(k_pack, jg)
            params = model.init(k_init, jg)
        return super().run(g, params=_numpy_tree(params), pack=pack)


def _centralized_from_reference(g, model="gat", steps=200, lr=0.01, weight_decay=1e-3,
                                seed=0, mcfg=None, gcn_hidden=16, *, device=None):
    jg = JGraph(*g)
    k_pack, k_init = jax.random.split(jax.random.PRNGKey(seed))
    pack = None
    if model == "gcn":
        params = j_init_gcn_params(k_init, jg.feature_dim, gcn_hidden, jg.num_classes)
    else:
        jmcfg = (JFedGATConfig(**reference_fields(mcfg)) if mcfg is not None
                 else JFedGATConfig(engine="exact" if model == "gat" else "direct"))
        net = JFedGAT(jmcfg)
        pack = net.precommunicate(k_pack, jg)
        params = net.init(k_init, jg)
    return trainer.train_centralized(g, model, steps, lr, weight_decay, seed, mcfg, gcn_hidden,
                                     device=device, params=_numpy_tree(params), pack=pack)


@pytest.fixture
def from_reference(monkeypatch):
    monkeypatch.setattr(repro_torch.federated, "Trainer", _FromReference)
    monkeypatch.setattr(repro_torch.federated, "train_centralized", _centralized_from_reference)


def assert_rows_within_one_node(rows, jrows):
    """Keys, order and every column but the accuracies equal; accuracies
    in [0, 1] and within one test node of the reference's."""
    one = 1.0 / TEST_NODES + 1e-9
    assert len(rows) == len(jrows)
    for row, jrow in zip(rows, jrows):
        assert list(row) == list(jrow)
        for k, want in jrow.items():
            if k in ACC_KEYS:
                assert 0.0 <= row[k] <= 1.0, (k, row)
                assert abs(row[k] - want) <= one, (k, row, jrow)
            else:
                assert row[k] == want, (k, row, jrow)


def sweep_pair(port, ref, **kw):
    rows = port.run(fast=True, dataset="tiny", device=CPU, **kw)
    jrows = ref.run(fast=True, dataset="tiny", **kw)
    return rows, jrows


def test_table1_rows_from_the_reference_params(from_reference):
    rows, jrows = sweep_pair(table1_accuracy, j_table1)
    assert [(r["method"], r["setting"]) for r in rows] == [
        ("GCN", "central"), ("GAT", "central"),
        ("distgat", "10 clients, non-iid"), ("distgat", "10 clients, iid"),
        ("fedgcn", "10 clients, non-iid"), ("fedgcn", "10 clients, iid"),
        ("fedgat", "10 clients, non-iid"), ("fedgat", "10 clients, iid")]
    assert_rows_within_one_node(rows, jrows)
    assert isinstance(table1_accuracy.derived(rows), str)
