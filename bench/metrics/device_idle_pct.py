"""The device's idle share of the profiled call: the part of its window in
which no kernel, copy or fill runs on the card, in %. Moves
``train_round_s``."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_s <= 0:
        return None
    return 100.0 * (p.window_s - p.busy_s) / p.window_s
