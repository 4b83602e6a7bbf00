"""The control of the comparison comes out not correct: the reference put
in the program's place with TF32 on, the precision below the float32 the
configurations state. Needs the card (TF32 exists only there); on the
card it runs at a graph a test can hold, with the configurations' widths."""
import pytest
import torch

from bench.harness.main import checks_of, is_correct

from conftest import CELLS, cut_cell

# d 128 and B 32 as the configurations; N cut to 40,000.
GRAPH = {"num_nodes": 40000, "undirected_edges": 275000, "splits": [21000, 7000, 12000]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 31 + 6, 2 ** 31 + 7])
def test_tf32_control_is_not_correct(name, seed):
    if not torch.cuda.is_available():
        pytest.skip("TF32 runs only on a CUDA device")
    cell = cut_cell(name, GRAPH)
    drv = cell.runner()
    inputs = drv.prepare(cell, seed, "cuda")
    pr = drv.reference_problem(cell, inputs, "cuda")
    ref = drv.reference_round(cell, pr, inputs)
    control = drv.reference_round(cell, pr, inputs, tf32=True)
    numbers = drv.compare(cell, pr, inputs, control, ref)
    assert not is_correct(checks_of(numbers, cell.settings["limits"])), numbers
