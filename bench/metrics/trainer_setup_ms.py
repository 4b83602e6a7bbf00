"""Trainer set-up inside every call (``federated/trainer.py``): partition,
client masks, parameter and optimizer init, the result's reports. Per call,
not per round: a call of ``rounds_per_call`` rounds pays it once, and each
round carries this over ``rounds_per_call``. The call's synchronized wall
time less its ``round`` spans, in ms, averaged over the window's calls.
Left out besides is the privacy accounting that only a traced run does:
with telemetry on, ``record_epsilon`` runs after each round and ends in a
``privacy.round`` event, so the time from the end of a round to that event
is not counted. Moves ``train_round_s``."""


def read(ctx):
    per_call = []
    for c in ctx.calls:
        spans = c.get("spans")
        if not spans:
            continue
        rounds = [r for r in spans if r.name == "round" and r.depth == 0]
        ends = [r.start_ns + r.dur_ns for r in rounds]
        accounting = sum(e["ns"] - max((t for t in ends if t <= e["ns"]), default=e["ns"])
                         for e in c.get("events", ()) if e["event"] == "privacy.round")
        untimed = c["wall_s"] * 1e9 - sum(r.dur_ns for r in rounds) - accounting
        per_call.append(untimed / 1e6)
    return sum(per_call) / len(per_call) if per_call else None
