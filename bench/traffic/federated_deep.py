"""Runner of the ``federated_deep`` traffic kind: federated GAT training of
models deeper than two layers, with the GAT paper's skip, through the
program's ``run_federated``.

A traffic file of this kind has the fields of the ``federated`` kind
(``traffic/federated.py``), whose set-up, warm call, window and profiled
call this runner takes unchanged. What differs is the model: the
program's ``FedGATConfig`` is built with the configuration's ``skip``
before anything else, so that a program without the field fails at once
rather than train another model; the initial params carry ``P`` on each
hidden layer after the first, drawn after the layer's ``a2``; the leaves
go in the program's tree order (W, a1, a2, P a layer); the operations
are counted by ``counts/fedgat_kernel_skip.py``; and the reference is
``reference/fedgat_skip.py``.
"""
from __future__ import annotations

import math
import time
from dataclasses import replace
from typing import Dict, List, Optional

import torch

from bench.counts import fedgat_kernel_skip as counts
from bench.harness import spec
from bench.harness.profiling import profile_call
from bench.reference import fedgat_skip as reference

base = spec.load_module(spec.BENCH / "traffic" / "federated.py", "bench_traffic_federated")
Inputs, Context, ProgramState = base.Inputs, base.Context, base.ProgramState
sync, warm_call, run_window, free = base.sync, base.warm_call, base.run_window, base.free
reference_problem, clients_a_round, shapes_of = (base.reference_problem, base.clients_a_round,
                                                 base.shapes_of)


def model_config(model: dict):
    """The program's ``FedGATConfig`` of the configuration's model."""
    from repro_torch.core.fedgat_model import FedGATConfig

    return FedGATConfig(
        hidden=int(model["hidden"]), heads=int(model["heads"]),
        out_heads=int(model["out_heads"]), num_layers=int(model["num_layers"]),
        degree=int(model["degree"]), domain=tuple(float(x) for x in model["domain"]),
        basis=model["basis"], engine=model["engine"], leaky_slope=float(model["leaky_slope"]),
        skip=bool(model.get("skip", False)))


def init_params(model: dict, d_in: int, classes: int, seed: int, device) -> List[Dict]:
    """Uniform(-lim, lim) leaves, lim = 0.5 sqrt(6 / (d_in + d_out)) a
    layer (the program's init distribution; P as W), drawn in one call on
    the device, in tree order."""
    shapes = counts.layers(model, d_in, classes)
    keys = reference.layer_keys(model)
    sizes = [[h * di * do if k in ("W", "P") else h * do for k in ks]
             for (h, di, do, _), ks in zip(shapes, keys)]
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    u = torch.rand(sum(map(sum, sizes)), generator=gen, device=device) * 2.0 - 1.0
    out, pos = [], 0
    for (h, di, do, _), ks, ns in zip(shapes, keys, sizes):
        lim = 0.5 * math.sqrt(6.0 / (di + do))
        layer = {}
        for k, n in zip(ks, ns):
            view = (h, di, do) if k in ("W", "P") else (h, do)
            layer[k] = (u[pos:pos + n].view(view) * lim).clone()
            pos += n
        out.append(layer)
    return out


def leaves(params: List[Dict]) -> List[torch.Tensor]:
    return [t for layer in params for t in layer.values()]


def prepare(cell, seed: int, device) -> Inputs:
    from bench.harness import graphgen

    seeds = base.derive_seeds(seed)
    gs = cell.config["graph"]
    graph = graphgen.make_graph_inputs(gs, seeds["graph"])
    params0 = init_params(cell.config["model"], int(gs["feature_dim"]), int(gs["num_classes"]),
                          seeds["params"], device)
    return Inputs(seeds, graph, params0)


def program_state(cell, inputs: Inputs, device) -> ProgramState:
    """The ``federated`` kind's state with the configuration's model, skip
    included."""
    state = base.program_state(cell, inputs, device)
    state.cfg = replace(state.cfg, model=model_config(cell.config["model"]))
    return state


def reference_round(cell, pr, inputs: Inputs, *, tf32: bool = False,
                    fault: Optional[str] = None):
    with base.precision(tf32):
        return reference.run_round(pr, leaves(inputs.params0),
                                   base.round_spec(cell, inputs.seeds), fault=fault)


def compare(cell, pr, inputs: Inputs, prog, ref, window=None) -> Dict[str, float]:
    """The numbers compared; with ``window`` (a ``WindowRecorder``), the
    window's calls are judged beside the warm call."""
    judged = () if window is None else window.params
    logits = None if window is None else window.logits
    with base.precision(False):
        return reference.judge(pr, leaves(inputs.params0), prog, ref, judged, logits)


def round_flops(cell) -> int:
    gs = cell.config["graph"]
    return counts.round_flops(cell.config["model"], gs, int(gs["neighbor_cap"]),
                              int(cell.traffic["local_steps"]), clients_a_round(cell))


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    """As the ``federated`` kind's ``measure``, with this model's pieces."""
    from repro_torch import telemetry

    model_config(cell.config["model"])             # a program without the skip stops here
    dev = torch.device(device)
    telemetry.disable()
    inputs = prepare(cell, seed, dev)
    state = program_state(cell, inputs, dev)
    warm_call(state, cell)
    sync(dev)
    setup_s = time.perf_counter() - t_start
    cuda = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    if trace:
        telemetry.reset()
        telemetry.enable()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    clock_ns = time.time_ns() - time.perf_counter_ns()     # events' stamps to perf_counter
    calls = run_window(state, seconds)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    rounds = sum(c["rounds"] for c in calls)
    train_round_s = sum(c["wall_s"] for c in calls) / rounds
    ctx = Context(cell=cell, calls=calls, train_round_s=train_round_s,
                  round_flops=round_flops(cell), shapes=shapes_of(cell))
    if trace:
        records = telemetry.records()
        events = [dict(e, ns=e["ts"] * 1e9 - clock_ns) for e in telemetry.events()]
        for c in calls:
            lo, hi = c["start"] * 1e9, c["end"] * 1e9
            c["spans"] = [r for r in records if lo <= r.start_ns < hi]
            c["events"] = [e for e in events if lo <= e["ns"] < hi]
        telemetry.reset()
        _, ctx.profile = profile_call(state.call, telemetry.records, device=dev)
        ctx.profile_steps = (state.cfg.rounds * int(cell.traffic["local_steps"])
                             * clients_a_round(cell))
        telemetry.disable()
        telemetry.reset()

    prog, window = state.reading, state.window
    if len(window.params) != len(calls):
        raise RuntimeError(
            f"{len(window.params)} of the window's {len(calls)} calls handed on their first "
            "round: the benchmark reads the trainer's setup_run and masked_accuracy")
    free(state)
    pr = reference_problem(cell, inputs, dev)
    ref = reference_round(cell, pr, inputs)
    numbers = compare(cell, pr, inputs, prog, ref, window)
    return {
        "end_to_end": {"train_round_s": train_round_s,
                       "train_peak_gib": window_peak / 2 ** 30, "setup_s": setup_s},
        "context": ctx, "numbers": numbers, "attempted": rounds, "failed": 0,
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
        "window": {"calls": len(calls), "judged": len(window.params), "hook_s": window.hook_s,
                   "call_s": [c["wall_s"] for c in calls]},
    }
