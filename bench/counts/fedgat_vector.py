"""Float32 operations of a FedGAT local step and evaluation under the
``vector`` engine (paper Appendix F), then the shared layers of
:mod:`bench.counts.gat`. The pack's g = 2B slots are contracted in full,
as the algorithm does: the masks' odd slots are multiplied out, not
skipped.

Layer 1 forward: b = W^T a (two), D = b1 M1 + b2 M2, R = D * mask4,
Horner of degree p, s * mask4, SE = s K1, SF = s . K3, the division and
the projection by W. Its backward: through W, the division, SE and SF
back to s, the mask, the series' derivative, R, and D back to b1 and b2
(the pack takes no cotangent), then to W, a1 and a2.
"""
from __future__ import annotations

from bench.counts import gat


def layer1(nodes: int, b: int, d: int, heads: int, d_out: int, degree: int) -> tuple:
    n, h, o, p, g = nodes, heads, d_out, degree, 2 * b
    nhg = n * h * g
    fwd = (4 * h * d * o + 4 * n * h * d * g + nhg * (5 + 2 * p)
           + 2 * n * h * g * d + n * h * d + 2 * n * h * d * o)
    bwd = (4 * n * h * d * o + 4 * n * h * d + 6 * n * h * g * d + nhg * (4 + 2 * p)
           + 8 * h * d * o)
    return fwd, bwd


def round_flops(model: dict, graph: dict, b: int, local_steps: int, clients: int) -> int:
    n, d, c = int(graph["num_nodes"]), int(graph["feature_dim"]), int(graph["num_classes"])
    f1, b1 = layer1(n, b, d, int(model["heads"]), int(model["hidden"]), int(model["degree"]))
    step, evaluate = gat.step_and_eval(f1, b1, model, n, b, d, c)
    return clients * local_steps * step + evaluate
