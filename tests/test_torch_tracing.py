"""The port's spans over a whole federated call, their ids, their clock and
their device time.

A traced ``run_federated`` on a tiny graph, on the vmap loop and on the
cohort path, with client-level DP and pairwise masks: the call's top-level
spans are ``setup``, ``round``, ``privacy.accounting`` and ``report`` and
cover its wall time; each local step splits into ``forward``, ``backward``
and ``optimizer``; each selected client's masks sit under
``secure_agg_mask``; ``parent_id`` links agree with ``parent`` names; every
span carries the call's id; the params are bit for bit those of an
untraced run. A traced CPU run leaves CUDA uninitialized and every
``device_ns`` empty (in a subprocess that sees no card, so that neither
another test's CUDA use nor the manifest's device query counts);
events share the spans' clock. On the card, a span around a device sleep
reports at least the sleep's stream time, placed on the span clock.
"""
import collections
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch import telemetry
from repro_torch.core import FedGATConfig
from repro_torch.federated import FederatedConfig, run_federated
from repro_torch.graphs import make_cora_like
from repro_torch.privacy import PrivacyConfig

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOP = {"setup", "round", "privacy.accounting", "report"}
DEVICE_SPANS = ("round", "step", "local_step", "forward", "backward", "optimizer",
                "aggregate", "evaluate")


def _cfg(max_concurrent_clients):
    return FederatedConfig(
        num_clients=6, rounds=2, local_steps=2, client_fraction=0.5,
        max_concurrent_clients=max_concurrent_clients,
        model=FedGATConfig(engine="direct", degree=8),
        privacy=PrivacyConfig(clip=1.0, noise_multiplier=0.5, secure_agg=True,
                              secure_agg_mode="pairwise"))


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    return make_cora_like("tiny", seed=0)


def _traced(g, cfg):
    telemetry.reset()
    telemetry.enable()
    try:
        t0 = time.perf_counter_ns()
        res = run_federated(g, cfg, device=CPU)
        wall = time.perf_counter_ns() - t0
        records = telemetry.records()
        events = telemetry.events()
    finally:
        telemetry.disable()
        telemetry.reset()
    return res, records, events, wall


@pytest.fixture(scope="module", params=[None, 2], ids=["vmap", "cohort"])
def traced(request, tiny):
    cfg = _cfg(request.param)
    return (cfg,) + _traced(tiny, cfg)


def test_the_call_is_covered_by_setup_rounds_accounting_and_report(tiny, traced):
    cfg, _, records, _, _ = traced
    top = [r for r in records if r.depth == 0]
    assert {r.name for r in top} == TOP
    assert [r.name for r in top].count("setup") == [r.name for r in top].count("report") == 1
    assert sum(r.name == "round" for r in top) == cfg.rounds
    # The share of the call's wall time: the best of three calls with the
    # collector off, so that a moment the loaded host spends descheduled or
    # collecting does not count against the program.
    covered = []
    gc.disable()
    try:
        for _ in range(3):
            _, recs, _, wall = _traced(tiny, cfg)
            covered.append(sum(r.dur_ns for r in recs if r.depth == 0) / wall)
    finally:
        gc.enable()
    assert max(covered) >= 0.98
    setup = {r.name for r in records if r.parent == "setup"}
    assert {"partition", "model_build", "client_masks", "optimizer_bank"} <= setup
    if cfg.max_concurrent_clients is not None:
        assert {"plan", "stager"} <= setup


def test_every_local_step_splits_into_forward_backward_and_optimizer(traced):
    cfg, _, records, _, _ = traced
    steps = [r for r in records if r.name == "local_step"]
    assert len(steps) == cfg.rounds * 3 * cfg.local_steps      # 3 clients a round
    children = collections.defaultdict(list)
    for r in records:
        children[r.parent_id].append(r.name)
    for s in steps:
        assert sorted(children[s.span_id]) == ["backward", "forward", "optimizer"]
    by_id = {r.span_id: r for r in records}
    for r in records:
        if r.name in ("step", "dp"):
            assert by_id[r.parent_id].name in ("round", "cohort", "step")


def test_pairwise_masks_sit_under_secure_agg_mask_once_a_client(traced):
    cfg, _, records, _, _ = traced
    masks = [r for r in records if r.name == "secure_agg_mask"]
    steps = [r for r in records if r.name == "step"]
    assert len(masks) == len(steps) == cfg.rounds * 3
    assert all(r.parent in ("round", "cohort") for r in masks)


def test_parent_ids_match_parent_names_and_every_span_has_the_call(traced):
    _, _, records, _, _ = traced
    by_id = {r.span_id: r for r in records}
    assert len(by_id) == len(records)
    for r in records:
        if r.parent is None:
            assert r.parent_id is None and r.depth == 0
        else:
            assert by_id[r.parent_id].name == r.parent
            assert by_id[r.parent_id].depth == r.depth - 1
    assert len({r.args["call"] for r in records}) == 1


def test_the_accounting_event_ends_its_span_on_the_spans_clock(traced):
    _, _, records, events, _ = traced
    acc = [r for r in records if r.name == "privacy.accounting"]
    rounds = [e for e in events if e["event"] == "privacy.round"]
    assert len(acc) == len(rounds) == 2
    for r, e in zip(acc, rounds):
        assert r.start_ns <= e["t_ns"] <= r.start_ns + r.dur_ns
        assert r.args["round"] == e["round"]


def test_tracing_moves_no_bit_of_the_result(tiny, traced):
    cfg, res, _, _, _ = traced
    plain = run_federated(tiny, cfg, device=CPU)
    assert plain["val_curve"] == res["val_curve"]
    for a, b in zip(plain["params"].parameters(), res["params"].parameters()):
        assert torch.equal(a, b)


def test_events_and_spans_share_one_clock():
    telemetry.reset()
    telemetry.enable()
    try:
        with telemetry.span("outer"):
            telemetry.event("inside")
        after = time.perf_counter_ns()
        (rec,), (evt,) = telemetry.records(), telemetry.events()
        trace = telemetry.export_chrome_trace()
    finally:
        telemetry.disable()
        telemetry.reset()
    assert rec.start_ns <= evt["t_ns"] <= rec.start_ns + rec.dur_ns <= after
    clock = trace["otherData"]["clock"]
    assert clock["base_ns"] == rec.start_ns
    # the anchor maps the span clock onto the Unix-epoch one
    unix = clock["base_ns"] - clock["perf_ns"] + clock["unix_ns"]
    assert abs(unix / 1e9 - evt["ts"]) < 0.05


def test_a_disabled_device_span_is_the_shared_no_op():
    assert not telemetry.enabled()
    assert telemetry.device_span("forward", client=1) is telemetry.NULL_SPAN


CPU_RUN = """
import json, torch
from repro_torch import telemetry
from repro_torch.core import FedGATConfig
from repro_torch.federated import FederatedConfig, run_federated
from repro_torch.graphs import make_cora_like
torch.set_num_threads(1)
telemetry.enable()
cfg = FederatedConfig(num_clients=4, rounds=1, local_steps=1,
                      model=FedGATConfig(engine="direct", degree=8))
run_federated(make_cora_like("tiny", seed=0), cfg, device="cpu")
recs = telemetry.records()
trace = telemetry.export_chrome_trace()
print(json.dumps({"cuda": torch.cuda.is_initialized(),
                  "device_ns": sorted({str(r.device_ns) for r in recs}),
                  "names": sorted({r.name for r in recs}),
                  "tids": sorted({e["tid"] for e in trace["traceEvents"]} )}))
"""


def test_a_traced_cpu_run_leaves_cuda_uninitialized():
    out = subprocess.run([sys.executable, "-c", CPU_RUN], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, check=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES=""))
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["cuda"] is False
    assert got["device_ns"] == ["None"]
    assert set(DEVICE_SPANS) <= set(got["names"])
    assert len(got["tids"]) == 1                 # no device track


class _FakeEvent:
    """A CUDA timing event on a made-up stream clock: each record advances
    the clock by 1 ms."""

    clock_ns = 0

    def __init__(self, enable_timing=False):
        self.at = self.stream = None

    def record(self, stream=None):
        _FakeEvent.clock_ns += 1_000_000
        self.at, self.stream = _FakeEvent.clock_ns, stream

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.at - self.at) / 1e6


def test_device_spans_pair_events_on_the_entry_stream_and_reuse_them(monkeypatch):
    from types import SimpleNamespace

    from repro_torch.telemetry import tracing

    streams = iter(["s0", "s1", "s2", "s3"])
    fake = SimpleNamespace(cuda=SimpleNamespace(
        Event=_FakeEvent, current_stream=lambda: next(streams), synchronize=lambda: None,
        current_device=lambda: 0))
    monkeypatch.setattr(tracing, "_cuda", lambda: fake)
    tr = tracing.Tracer()                      # anchor event at 1 ms
    with tr.device_span("outer", call=7):      # entry 2 ms on s0
        with tr.span("host"):
            pass
        with tr.device_span("inner"):          # entry 3 ms on s1, exit 4 ms
            pass
    # outer exit 5 ms, on s0 again
    host, inner, outer = tr.resolve()
    assert (outer.device_ns, inner.device_ns, host.device_ns) == (3_000_000, 1_000_000, None)
    anchor = tr.anchor.perf_ns
    assert (outer.device_start_ns, inner.device_start_ns) == (anchor + 1_000_000,
                                                              anchor + 2_000_000)
    assert inner.args == {"call": 7} and inner.parent_id == outer.span_id
    freed = set(map(id, tr._free))
    assert len(freed) == 4 and all(e.stream in ("s0", "s1") for e in tr._free)
    with tr.device_span("again"):
        pass
    assert len(tr._free) == 2 and set(map(id, tr._free)) < freed
    trace = tr.to_chrome()
    device = [e for e in trace["traceEvents"] if e.get("cat") == "repro_torch.device"]
    assert [e["name"] for e in device] == ["inner", "outer", "again"]
    assert {e["tid"] for e in device} == {tracing.DEVICE_TID}


@pytest.mark.cuda
def test_a_device_span_reports_the_stream_time_of_its_work():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.init()
    cycles = 20_000_000
    telemetry.reset()
    telemetry.enable()
    try:
        with telemetry.device_span("sleep"):
            torch.cuda._sleep(cycles)
        with telemetry.span("host"):
            pass
        sleep, host = telemetry.records()
        trace = telemetry.export_chrome_trace()
    finally:
        telemetry.disable()
        telemetry.reset()
    # no H100 clock runs above 2 GHz: the spin takes at least cycles / 2e9 s
    assert sleep.device_ns >= cycles / 2.0
    assert host.device_ns is None and host.device_start_ns is None
    # the stream reached the entry event after the host recorded it
    assert sleep.device_start_ns >= sleep.start_ns - 100_000
    device = [e for e in trace["traceEvents"] if e.get("cat") == "repro_torch.device"]
    assert [e["name"] for e in device] == ["sleep"]
    assert device[0]["dur"] == sleep.device_ns / 1e3
