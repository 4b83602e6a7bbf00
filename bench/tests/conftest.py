"""Fixtures of the benchmark's own tests: cells cut to a graph a CPU test
can hold, and the repository's root and ``src`` on the import path."""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The widths of the configurations stay; the graph is cut for the CPU.
TINY_GRAPH = {"num_nodes": 2000, "feature_dim": 16, "num_classes": 5, "undirected_edges": 8000,
              "splits": [1000, 400, 600], "edge_homophily": 0.65, "word_keep": 0.5,
              "word_noise": 0.15, "neighbor_cap": 8}
CELLS = ("train.arxiv.kernel", "train.arxiv.vector", "train.arxiv.kernel.cohort-dp")


def cut_cell(name, graph=TINY_GRAPH):
    from bench.harness import spec

    cell = spec.load_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["graph"].update(graph)
    return cell


@pytest.fixture(params=CELLS)
def tiny_cell(request):
    import torch

    torch.set_num_threads(1)
    return cut_cell(request.param)
