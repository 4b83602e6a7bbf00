"""``fig2_clients``' accuracy rows against the reference's, at its ``fast``
sweep on ``tiny``, from the reference's initial params, held as
``tests/test_torch_paper_sweeps.py`` sets out: accuracies within one test
node, every other column exactly.
"""
import pytest
import torch

from benchmarks import fig2_clients as j_fig2
from benchmarks_torch import fig2_clients
from test_torch_paper_sweeps import assert_rows_within_one_node, from_reference, sweep_pair

torch.set_num_threads(1)

__all__ = ["from_reference"]      # the fixture, shared with the table1 file


@pytest.mark.usefixtures("from_reference")
def test_fig2_rows_from_the_reference_params():
    rows, jrows = sweep_pair(fig2_clients, j_fig2)
    assert [(r["method"], r["setting"], r["clients"]) for r in rows] == [
        (m, s, k) for m in ("fedgat", "distgat", "fedgcn") for s in ("non-iid", "iid")
        for k in (1, 10)]
    assert_rows_within_one_node(rows, jrows)
    assert fig2_clients.derived(rows).startswith("fedgat@10cl=")
