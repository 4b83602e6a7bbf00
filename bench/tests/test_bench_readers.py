"""Per-layer readers on made-up spans and events, where what they must
leave out is known."""
from types import SimpleNamespace

import pytest

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


# A call of three rounds, as the window's calls hold many: 2 clients x 2
# local steps a round, so 12 local steps a call.
ROUNDS, CLIENTS, STEPS = 3, 2, 2
SHAPES = {"heads": 8, "nodes": 1000, "b": 32, "d": 128, "coeffs": 17}


def three_round_call(start_ms=0.0):
    """A call of 3000 ms: 150 ms of set-up, three rounds of 900 ms, each
    followed by 10 ms of traced privacy accounting, and a report after."""
    spans, events = [], []
    t = start_ms + 150
    for _ in range(ROUNDS):
        spans.append(span("round", t, 900))
        for s in range(CLIENTS * STEPS):
            spans.append(SimpleNamespace(name="forward", start_ns=int((t + s) * 1e6), dur_ns=1,
                                         depth=3, parent="local_step", device_ns=int(20e6)))
            spans.append(SimpleNamespace(name="backward", start_ns=int((t + s) * 1e6),
                                         dur_ns=1, depth=3, parent="local_step",
                                         device_ns=int(30e6)))
        spans.append(span("staging", t + 800, 4, depth=2))
        spans.append(span("secure_agg_mask", t + 850, 2, depth=2))
        events.append({"event": "privacy.round", "ns": (t + 910) * 1e6})
        t += 910
    return {"wall_s": 3.0, "rounds": ROUNDS, "spans": spans, "events": events}


def profiled(kernel_ms, launches, nbr_bwd_s, window_s=3.0, busy_s=2.4):
    from bench.harness.profiling import Profile

    kernels = [("void cheb_attn_fwd_kernel<32>", kernel_ms / 1e3)] * launches
    kernels += [("void cheb_attn_bwd_kernel<0, 0>", 2 * kernel_ms / 1e3)] * launches
    return Profile(window_s=window_s, busy_s=busy_s, kernels=kernels,
                   op_device={"NbrGatherBackward": nbr_bwd_s})


def many_round_ctx():
    calls = [three_round_call(0.0), three_round_call(3000.0)]
    return SimpleNamespace(
        calls=calls, train_round_s=sum(c["wall_s"] for c in calls) / (2 * ROUNDS),
        round_flops=67e12 * 0.01, shapes=SHAPES,
        profile=profiled(1.0, ROUNDS * CLIENTS * STEPS, 0.036),
        profile_steps=ROUNDS * CLIENTS * STEPS)


def roofline(kind, ms):
    from bench.counts import cheb_attn

    count = getattr(cheb_attn, kind)(SHAPES["heads"], SHAPES["nodes"], SHAPES["b"],
                                     SHAPES["d"], SHAPES["coeffs"])
    return 100.0 * cheb_attn.least_seconds(*count) / (ms / 1e3)


@pytest.mark.parametrize("metric,want", [
    # per call: 3000 ms less three 900-ms rounds and three 10-ms accountings
    ("trainer_setup_ms", 3000.0 - 3 * 900.0 - 3 * 10.0),
    # per round: 6 ms of staging and masks in each of the six rounds
    ("cohort_host_ms", 6.0),
    # per local step: the spans' mean, however many rounds hold them
    ("step_forward_ms", 20.0),
    ("step_backward_ms", 30.0),
    # per local step: the profiled call's device time over its 12 steps
    ("nbr_gather_bwd_ms", 3.0),
    # per round: a round's operations over a round's time (1 s)
    ("train_mfu", 1.0),
    # per launch: the mean launch, however many the call made
    ("cheb_attn_fwd_roofline", roofline("forward", 1.0)),
    ("cheb_attn_bwd_roofline", roofline("backward", 2.0)),
    # of the profiled call
    ("device_idle_pct", 20.0),
])
def test_a_reader_of_calls_of_many_rounds_reads_per_call_round_step_or_launch(metric, want):
    got = spec.metric_reader(metric)(many_round_ctx())
    assert got == pytest.approx(want, rel=1e-9), (metric, got, want)
