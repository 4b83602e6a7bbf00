"""The readers of the program's device-timed spans on made-up spans, where
what they must leave out is known; and the trainer's set-up reading, which
the spans that cover a whole call must not move."""
from types import SimpleNamespace

import pytest

from bench.harness import spec


def span(name, start_ms, dur_ms, depth=0, parent=None, device_ms=None):
    return SimpleNamespace(name=name, start_ns=int(start_ms * 1e6), dur_ns=int(dur_ms * 1e6),
                           depth=depth, parent=parent,
                           device_ns=None if device_ms is None else int(device_ms * 1e6))


def ctx_of(*spans_a_call):
    return SimpleNamespace(calls=[{"wall_s": 1.0, "rounds": 1, "spans": list(s)}
                                  for s in spans_a_call])


@pytest.mark.parametrize("metric,name", [("step_forward_ms", "forward"),
                                         ("step_backward_ms", "backward")])
def test_a_step_reader_takes_the_mean_device_time_inside_local_steps(metric, name):
    read = spec.metric_reader(metric)
    ctx = ctx_of(
        [span(name, 0, 10, depth=3, parent="local_step", device_ms=40.0),
         span(name, 20, 10, depth=3, parent="local_step", device_ms=20.0),
         # a centralised baseline's or a probe's: not a local step
         span(name, 40, 10, depth=0, device_ms=1000.0),
         span(name, 60, 10, depth=1, parent="evaluate", device_ms=1000.0),
         # the other half of the step
         span("forward" if name == "backward" else "backward", 80, 10, depth=3,
              parent="local_step", device_ms=1000.0)],
        [span(name, 0, 10, depth=3, parent="local_step", device_ms=60.0)])
    assert abs(read(ctx) - 40.0) < 1e-9


@pytest.mark.parametrize("metric,name", [("step_forward_ms", "forward"),
                                         ("step_backward_ms", "backward")])
def test_a_step_reader_gives_nothing_without_device_time(metric, name):
    read = spec.metric_reader(metric)
    # a CPU run's spans, and an older program's records without the field
    cpu = span(name, 0, 10, depth=3, parent="local_step")
    old = SimpleNamespace(name=name, start_ns=0, dur_ns=10, depth=3, parent="local_step")
    assert read(ctx_of([cpu], [old])) is None
    assert read(SimpleNamespace(calls=[{"wall_s": 1.0, "rounds": 1}])) is None


def test_trainer_setup_is_unmoved_by_the_spans_that_cover_a_call():
    read = spec.metric_reader("trainer_setup_ms")
    rounds = [span("round", 100, 700), span("step", 100, 600, depth=1, parent="round")]
    events = [{"event": "privacy.round", "ns": 950e6}]
    covered = rounds + [span("setup", 0, 100), span("partition", 10, 30, depth=1,
                                                    parent="setup"),
                        span("privacy.accounting", 940, 10), span("report", 960, 40),
                        span("comm", 965, 30, depth=1, parent="report")]
    plain = {"wall_s": 1.0, "rounds": 1, "spans": rounds, "events": events}
    spanned = dict(plain, spans=covered)
    assert read(SimpleNamespace(calls=[plain])) == read(SimpleNamespace(calls=[spanned]))
    assert abs(read(SimpleNamespace(calls=[spanned])) - 150.0) < 1e-6
