"""Per-layer readers on made-up spans and events, where what they must
leave out is known."""
from types import SimpleNamespace

from bench.harness import spec


def span(name, start_ms, dur_ms, depth=0):
    return SimpleNamespace(name=name, start_ns=int(start_ms * 1e6), dur_ns=int(dur_ms * 1e6),
                           depth=depth)


def test_trainer_setup_leaves_out_the_traced_privacy_accounting():
    read = spec.metric_reader("trainer_setup_ms")
    call = {"wall_s": 1.0, "rounds": 1,
            "spans": [span("round", 100, 700), span("step", 100, 600, depth=1)],
            "events": [{"event": "privacy.round", "ns": 950e6}]}
    # 1000 ms of wall, 700 in the round, 150 from the round's end to the event
    assert abs(read(SimpleNamespace(calls=[call])) - 150.0) < 1e-6
    del call["events"]
    assert abs(read(SimpleNamespace(calls=[call])) - 300.0) < 1e-6


def test_an_untraced_window_gives_no_trainer_setup():
    read = spec.metric_reader("trainer_setup_ms")
    assert read(SimpleNamespace(calls=[{"wall_s": 1.0, "rounds": 1}])) is None
