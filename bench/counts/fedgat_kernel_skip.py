"""Float32 operations of a local step and an evaluation of FedGAT models of
any depth under the ``kernel`` engine, with the skip of the GAT paper's
inductive model: layer 1 as :func:`bench.counts.fedgat_kernel.layer1`,
each later layer as :func:`bench.counts.gat.gat_layer`, and on each hidden
layer after the first the skip ``x P`` (one GEMM of the layer's input
against every head's P, then the add), counted as the rest of
:mod:`bench.counts.gat` is: a multiply-add two, the cotangents the step
needs, nothing recomputed.
"""
from __future__ import annotations

from bench.counts import fedgat_kernel, gat


def layers(model: dict, d_in: int, classes: int):
    """``[(heads, d_in, d_out, skip), ...]``: layer 1, the hidden layers
    after it, the output layer."""
    h, hid, depth = int(model["heads"]), int(model["hidden"]), int(model["num_layers"])
    skip = bool(model.get("skip", False))
    return ([(h, d_in, hid, False)] + [(h, h * hid, hid, skip)] * (depth - 2)
            + [(int(model["out_heads"]), h * hid, classes, False)])


def skip(nodes: int, d_in: int, heads: int, d_out: int) -> tuple:
    """(forward, backward) flops of the skip: x P and the add; dP and dx."""
    gemm = 2 * nodes * d_in * heads * d_out
    return gemm + nodes * heads * d_out, 2 * gemm


def num_params(shapes) -> int:
    """W, a1, a2 a layer, and P beside W where the layer has the skip."""
    return sum((2 if s else 1) * h * di * do + 2 * h * do for h, di, do, s in shapes)


def step_and_eval(model: dict, nodes: int, b: int, d_in: int, classes: int) -> tuple:
    """(flops of one local step, flops of one evaluation forward)."""
    shapes = layers(model, d_in, classes)
    h1, _, o1, _ = shapes[0]
    f1, b1 = fedgat_kernel.layer1(nodes, b, d_in, h1, o1, int(model["degree"]))
    fwd, bwd = f1, b1
    for h, di, do, has_skip in shapes[1:]:
        e_f, e_b = gat.elu(nodes, di)                   # the ELU before this layer
        g_f, g_b = gat.gat_layer(nodes, b, di, h, do)
        s_f, s_b = skip(nodes, di, h, do) if has_skip else (0, 0)
        fwd += e_f + g_f + s_f
        bwd += e_b + g_b + s_b
    l_f, l_b = gat.cross_entropy(nodes, classes)
    step = fwd + l_f + bwd + l_b + gat.adam(num_params(shapes))
    return step, fwd + 2 * gat.accuracy(nodes, classes)


def round_flops(model: dict, graph: dict, b: int, local_steps: int, clients: int) -> int:
    """Flops of one round: ``clients`` x ``local_steps`` local steps and one
    evaluation forward."""
    n, d, c = int(graph["num_nodes"]), int(graph["feature_dim"]), int(graph["num_classes"])
    step, evaluate = step_and_eval(model, n, b, d, c)
    return clients * local_steps * step + evaluate
