"""The ``cheb_attn`` backward kernel's share of its roofline
(``kernels/cheb_attn.py``, ``csrc/cheb_attn.cu``): the least time of a
launch at the cell's shape (``bench/counts/cheb_attn.py``: bytes at
3.35 TB/s or float32 operations at 67 TFLOP/s, whichever is longer) over
the kernel's mean device time in the profiled call, in %. Moves
``train_round_s``."""

from bench.counts import cheb_attn

KERNEL = "cheb_attn_bwd_kernel"


def read(ctx):
    if ctx.profile is None:
        return None
    times = ctx.profile.kernel_durations(KERNEL)
    if not times:
        return None
    s = ctx.shapes
    least = cheb_attn.least_seconds(*cheb_attn.backward(
        s["heads"], s["nodes"], s["b"], s["d"], s["coeffs"]))
    return 100.0 * least / (sum(times) / len(times))
