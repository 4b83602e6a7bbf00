"""repro_torch graphs, telemetry and series coefficients against the JAX
package: the numpy code is copied, so every array must be bit-identical."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import chebyshev as jcheb
from repro.graphs import graph as jgraph
from repro.graphs import make_cora_like as j_make_cora_like
from repro.graphs import make_sbm as j_make_sbm
from repro.telemetry.metrics import Histogram as JHistogram
from repro_torch import telemetry
from repro_torch.core import chebyshev
from repro_torch.graphs import graph as tgraph
from repro_torch.graphs import make_cora_like, make_sbm
from repro_torch.telemetry.metrics import Histogram

torch.set_num_threads(1)


def _assert_graphs_equal(g, jg):
    assert g._fields == jg._fields
    for f in g._fields:
        a, b = getattr(g, f), getattr(jg, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


@pytest.mark.parametrize("name", ["tiny", "cora_like"])
def test_make_cora_like_bit_identical(name):
    _assert_graphs_equal(make_cora_like(name, seed=3), j_make_cora_like(name, seed=3))


def test_make_sbm_bit_identical():
    _assert_graphs_equal(make_sbm("sbm_1k", seed=1), j_make_sbm("sbm_1k", seed=1))


@pytest.mark.parametrize("max_degree", [1, 4, 16])
def test_sample_neighbors_and_edge_list_bit_identical(max_degree):
    g, jg = make_sbm("sbm_1k", seed=0), j_make_sbm("sbm_1k", seed=0)
    _assert_graphs_equal(
        tgraph.sample_neighbors(g, max_degree, seed=5),
        jgraph.sample_neighbors(jg, max_degree, seed=5),
    )
    for loops in (False, True):
        np.testing.assert_array_equal(
            tgraph.edge_list(g, include_self_loops=loops),
            jgraph.edge_list(jg, include_self_loops=loops),
        )


def test_csr_builders_bit_identical():
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 50, size=(120, 2))
    for sym in (False, True):
        for loops in (False, True):
            a = tgraph.edges_to_csr(edges, 50, add_self_loops=loops, symmetrize=sym)
            b = jgraph.edges_to_csr(edges, 50, add_self_loops=loops, symmetrize=sym)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            for md in (None, 3):
                for x, y in zip(tgraph.csr_to_padded(*a, 8, md), jgraph.csr_to_padded(*b, 8, md)):
                    np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        tgraph.edges_to_csr(np.array([[0, 50]]), 50)


@pytest.mark.parametrize("basis", ["power", "chebyshev"])
@pytest.mark.parametrize("degree", [4, 8, 16])
def test_attention_series_bit_identical(degree, basis):
    a = chebyshev.attention_series(degree, (-4.0, 4.0), 0.2, basis=basis)
    b = jcheb.attention_series(degree, (-4.0, 4.0), 0.2, basis=basis)
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("basis", ["power", "chebyshev"])
def test_series_evaluation_matches_reference(basis):
    """Horner/Clenshaw in torch vs the reference's scans in float32, degree
    12 on the fitted domain, at the tolerance of tests/test_chebyshev.py:35
    (XLA may contract the reference's multiply-add into an FMA; torch does
    not, and the monomial sum cancels)."""
    coeffs = jcheb.attention_series(12, (-4.0, 4.0), basis=basis)
    x = np.random.default_rng(1).uniform(-4, 4, size=(3, 64)).astype(np.float32)
    if basis == "power":
        got = chebyshev.eval_power_series(coeffs, torch.from_numpy(x)).numpy()
        want = np.asarray(jcheb.eval_power_series(coeffs, jnp.asarray(x)))
    else:
        got = chebyshev.eval_chebyshev(coeffs, torch.from_numpy(x), (-4.0, 4.0)).numpy()
        want = np.asarray(jcheb.eval_chebyshev(coeffs, jnp.asarray(x), (-4.0, 4.0)))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_histogram_quantiles_match_reference():
    vals = np.random.default_rng(2).lognormal(-6, 1.5, size=500)
    h, jh = Histogram("x"), JHistogram("x")
    for v in vals:
        h.observe(v)
        jh.observe(v)
    for q in (0, 1, 50, 90, 99, 100):
        assert h.quantile(q) == jh.quantile(q)
    assert h.mean == jh.mean and h.count == jh.count


def test_span_is_off_by_default_and_records_when_enabled():
    assert not telemetry.enabled()
    with telemetry.span("off"):
        pass
    assert telemetry.records() == []
    telemetry.enable()
    try:
        with telemetry.span("outer", k=1):
            with telemetry.span("inner"):
                pass
    finally:
        telemetry.disable()
    recs = telemetry.records()
    telemetry.reset()
    assert [(r.name, r.depth) for r in recs] == [("inner", 1), ("outer", 0)]
    assert recs[1].args == {"k": 1} and recs[1].dur_ns >= recs[0].dur_ns


def test_apply_delta_bit_identical():
    from repro.serving.updates import GraphDelta as JGraphDelta
    from repro.serving.updates import apply_delta as j_apply_delta
    from repro_torch.serving.updates import GraphDelta, apply_delta

    g, jg = make_cora_like("tiny", seed=0), j_make_cora_like("tiny", seed=0)
    rng = np.random.default_rng(4)
    feats = rng.random((3, g.feature_dim)).astype(np.float32)
    edges = np.array([[g.num_nodes, 0], [g.num_nodes + 2, g.num_nodes + 1], [3, 9]])
    _assert_graphs_equal(
        apply_delta(g, GraphDelta(features=feats, labels=[1, 2, 0], edges=edges)),
        j_apply_delta(jg, JGraphDelta(features=feats, labels=[1, 2, 0], edges=edges)),
    )
    with pytest.raises(ValueError, match="endpoints"):
        apply_delta(g, GraphDelta(edges=np.array([[0, g.num_nodes]])))
    with pytest.raises(ValueError, match="dim"):
        apply_delta(g, GraphDelta(features=np.zeros((1, 3), np.float32)))


@pytest.mark.parametrize("n,lo,hi", [(0, 0, 1), (1, 0, 1), (7, -3, 3), (10_000, 0, 50),
                                     (100_000, -2**40, 2**40)])
def test_sorted_unique_is_np_unique(n, lo, hi):
    a = np.random.default_rng(n).integers(lo, hi, size=n, dtype=np.int64)
    got, want = tgraph.sorted_unique(a), np.unique(a)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
