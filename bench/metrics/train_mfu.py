"""The whole round's share of the card's float32 peak: the operations the
configuration's algorithm needs for every local step's forward and
backward and each evaluation forward (``bench/counts/fedgat_<engine>.py``,
nothing recomputed counted) over ``train_round_s`` times 67 TFLOP/s, in %.
Moves ``train_round_s``."""

from bench.counts.peaks import FP32_FLOPS_PER_S


def read(ctx):
    return 100.0 * ctx.round_flops / (ctx.train_round_s * FP32_FLOPS_PER_S)
