"""``fig5_degree``'s and ``fig6_vector``'s accuracy rows against the
reference's, at their ``fast`` sweeps on ``tiny``, from the reference's
initial params and packs (fig6 trains the ``vector`` engine on the
reference's pack), held as ``tests/test_torch_paper_sweeps.py`` sets out:
accuracies within one test node, every other column (fig6's comm columns
included) exactly.
"""
import pytest
import torch

from benchmarks import fig5_degree as j_fig5
from benchmarks import fig6_vector as j_fig6
from benchmarks_torch import fig5_degree, fig6_vector
from test_torch_paper_sweeps import assert_rows_within_one_node, from_reference, sweep_pair

torch.set_num_threads(1)

__all__ = ["from_reference"]      # the fixture, shared with the table1 file


@pytest.mark.usefixtures("from_reference")
def test_fig5_rows_from_the_reference_params():
    rows, jrows = sweep_pair(fig5_degree, j_fig5)
    assert [(r["setting"], r["degree"]) for r in rows] == [
        ("non-iid", 8), ("non-iid", 16), ("iid", 8), ("iid", 16)]
    assert_rows_within_one_node(rows, jrows)
    assert fig5_degree.derived(rows).startswith("max_acc_spread_over_degrees=")


@pytest.mark.usefixtures("from_reference")
def test_fig6_rows_from_the_reference_params():
    rows, jrows = sweep_pair(fig6_vector, j_fig6)
    assert [(r["setting"], r["clients"]) for r in rows] == [
        ("non-iid", 1), ("non-iid", 10), ("iid", 1), ("iid", 10)]
    assert_rows_within_one_node(rows, jrows)
    assert fig6_vector.derived(rows).startswith("mean_comm_speedup=")
