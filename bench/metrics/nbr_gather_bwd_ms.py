"""The local step's neighbour-gather backwards (``kernels/nbr_gather.py``,
``csrc/nbr_gather.cu``: the backward node of the ``NbrGather`` autograd
Function, its plan's sort and the kernel's levels included): device time a
local step, from the profiled call. A program without the Function gives
nothing. Moves ``train_round_s``."""


OP = "NbrGatherBackward"


def read(ctx):
    if ctx.profile is None or not ctx.profile_steps:
        return None
    ops = ctx.profile.op_device
    # the node itself, or where only the autograd engine's wrapper names it
    seconds = ops.get(OP) or sum(s for name, s in ops.items() if name.endswith(OP))
    return seconds * 1e3 / ctx.profile_steps if seconds > 0 else None
