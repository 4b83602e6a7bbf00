"""Float32 operations of a FedGAT local step and evaluation under the
``kernel`` engine: layer 1 is Eq. 7 directly over the padded neighbour
lists (the mathematics of the ``cheb_attn`` kernels), then the shared
layers of :mod:`bench.counts.gat`.

Layer 1 forward: b = W^T a (two), the scores' projections s = h b (two),
x = s1 + s2[nbr], Horner of degree p, the mask, the denominator, the
numerator sum_j e_ij h_j, the division and the projection by W. Its
backward: through W (dW and dagg), the division, the numerator (de), the
denominator and the mask, the series' derivative, the gather's
scatter-add, and back to b and to W, a1 and a2.
"""
from __future__ import annotations

from bench.counts import gat


def layer1(nodes: int, b: int, d: int, heads: int, d_out: int, degree: int) -> tuple:
    n, h, o, p = nodes, heads, d_out, degree
    hnb = h * n * b
    fwd = (4 * h * d * o + 4 * n * d * h + hnb * (3 + 2 * p)
           + 2 * hnb * d + h * n * d + 2 * h * n * d * o)
    bwd = (4 * h * n * d * o + 4 * h * n * d + 2 * hnb * d + hnb * (4 + 2 * p)
           + 4 * n * d * h + 8 * h * d * o)
    return fwd, bwd


def round_flops(model: dict, graph: dict, b: int, local_steps: int, clients: int) -> int:
    """Flops of one round: ``clients`` x ``local_steps`` local steps and one
    evaluation forward."""
    n, d, c = int(graph["num_nodes"]), int(graph["feature_dim"]), int(graph["num_classes"])
    f1, b1 = layer1(n, b, d, int(model["heads"]), int(model["hidden"]), int(model["degree"]))
    step, evaluate = gat.step_and_eval(f1, b1, model, n, b, d, c)
    return clients * local_steps * step + evaluate
