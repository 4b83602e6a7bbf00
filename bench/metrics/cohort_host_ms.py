"""Host work of cohort streaming and the privacy stack
(``federated/cohort.py``, ``privacy/``): the ``staging`` and
``secure_agg_mask`` spans' time a round, in ms: their sum over the
window's calls over the rounds those calls ran.
Only cohort-streamed traffic has these spans. Moves ``train_round_s``."""

NAMES = ("staging", "secure_agg_mask")


def read(ctx):
    total, rounds, seen = 0, 0, False
    for c in ctx.calls:
        spans = c.get("spans") or []
        mine = [r.dur_ns for r in spans if r.name in NAMES]
        seen = seen or bool(mine)
        total += sum(mine)
        rounds += c["rounds"]
    return total / 1e6 / rounds if seen else None
