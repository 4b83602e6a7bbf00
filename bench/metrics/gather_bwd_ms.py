"""The local step's gather backwards (``core/gat.py``,
``core/poly_attention.py``): device time a local step under PyTorch's
``IndexBackward0`` (the scatter-add of the gathers ``s2[:, nbr_idx]`` and
``z[:, nbr_idx, :]``), its kernels included, from the profiled call.
Moves ``train_round_s``."""


OP = "IndexBackward0"


def read(ctx):
    if ctx.profile is None or not ctx.profile_steps:
        return None
    ops = ctx.profile.op_device
    # the op itself, or where only the autograd engine's wrapper names it
    seconds = ops.get(OP) or sum(s for name, s in ops.items() if name.endswith(OP))
    return seconds * 1e3 / ctx.profile_steps if seconds > 0 else None
