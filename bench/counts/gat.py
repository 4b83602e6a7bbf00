"""Float32 operations of what every FedGAT engine shares: the exact GAT
layers after layer 1, the ELU between layers, the masked cross-entropy and
the Adam step. A multiply-add counts two, any other elementwise operation
one; a softmax five a score forward and four backward. Only the
cotangents the step needs are counted (the features take none), and
nothing recomputed.

Dimensions: N nodes, B neighbour slots, ``d_in`` the layer's input width,
``heads`` its heads, ``d_out`` its width a head, C classes.
"""
from __future__ import annotations


def gat_layer(nodes: int, b: int, d_in: int, heads: int, d_out: int,
              needs_input_grad: bool = True) -> tuple:
    """(forward, backward) flops of an exact GAT layer over padded lists."""
    n, h, o = nodes, heads, d_out
    fwd = (2 * n * d_in * o * h          # z = x W
           + 4 * h * n * o               # s1, s2
           + 7 * h * n * b               # scores, LeakyReLU, softmax
           + 2 * h * n * b * o           # sum_j alpha_ij z_j
           + h * n * o)                  # the heads' concat or mean
    bwd = (4 * h * n * b * o             # d alpha, d z_j and its scatter-add
           + 7 * h * n * b               # softmax, LeakyReLU, s1 and s2's gathers
           + 8 * h * n * o               # ds1, ds2 into dz; da1, da2
           + 2 * n * d_in * o * h)       # dW
    if needs_input_grad:
        bwd += 2 * n * d_in * o * h      # dx
    return fwd, bwd


def elu(nodes: int, width: int) -> tuple:
    return nodes * width, nodes * width


def cross_entropy(nodes: int, classes: int) -> tuple:
    """Masked mean cross-entropy over (N, C) logits."""
    return 4 * nodes * classes + 2 * nodes, 3 * nodes * classes


def accuracy(nodes: int, classes: int) -> int:
    return nodes * classes + 2 * nodes


def adam(num_params: int) -> int:
    return 14 * num_params


def num_params(layers) -> int:
    """Parameters of ``[(heads, d_in, d_out), ...]``: W, a1, a2 a layer."""
    return sum(h * di * do + 2 * h * do for h, di, do in layers)


def layers(model: dict, d_in: int, classes: int):
    """``[(heads, d_in, d_out), ...]`` of a two-layer FedGAT (layer 1, then
    the exact output layer)."""
    if int(model["num_layers"]) != 2:
        raise ValueError("the counts cover two-layer models")
    h, hid = int(model["heads"]), int(model["hidden"])
    return [(h, d_in, hid), (int(model["out_heads"]), h * hid, classes)]


def step_and_eval(layer1_fwd: int, layer1_bwd: int, model: dict, nodes: int, b: int,
                  d_in: int, classes: int) -> tuple:
    """(flops of one local step, flops of one evaluation forward) given
    layer 1's forward and backward."""
    (h1, _, o1), (h2, d2, _) = layers(model, d_in, classes)
    g_f, g_b = gat_layer(nodes, b, d2, h2, classes)
    e_f, e_b = elu(nodes, h1 * o1)
    l_f, l_b = cross_entropy(nodes, classes)
    p = num_params(layers(model, d_in, classes))
    step = layer1_fwd + e_f + g_f + l_f + layer1_bwd + e_b + g_b + l_b + adam(p)
    evaluate = layer1_fwd + e_f + g_f + 2 * accuracy(nodes, classes)
    return step, evaluate
