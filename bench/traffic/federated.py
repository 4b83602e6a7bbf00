"""Runner of the ``federated`` traffic kind: federated GAT training through
the program's ``run_federated``.

A traffic file of this kind gives the Trainer's fields (``num_clients``,
``beta``, ``client_fraction``, ``local_steps``, ``lr``, ``weight_decay``,
``aggregator``, ``max_concurrent_clients``, ``aggregation_mode``) and a
``privacy`` section; the configuration gives the model and the graph; the
cell's file gives ``rounds_per_call`` and the limits of the comparison.

Set-up makes the graph's arrays, the initial params and (for the vector
engine) the pack's masks from the seed, hands them to the program's graph
constructors and pack precomputation, and makes one warm call of one round with the
window's arguments, reading its local steps (``bench/harness/record.py``).
The window then runs whole calls of ``rounds_per_call`` rounds back to
back, each from the same params and pack, each ended by a synchronize, and
starts no call after ``seconds``. A call of many rounds is what a
deployment runs, and it spreads the call's own host work (the partition,
the model's build, the result's report) over its rounds. Every window
call starts from the same inputs as the warm call, so its first round is
the warm call's round: the window hands on each call's first-round global
params and the last call's first-round evaluation logits. The reference
follows that round from the same inputs once the program's state is
freed, and the comparison judges the warm call and the window's calls by
it; it needs no pack, since the pack's masked slots are multiplied by zero.
"""
from __future__ import annotations

import gc
import math
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from bench.counts import gat as gat_counts
from bench.harness import graphgen, spec
from bench.harness.profiling import Profile, profile_call
from bench.reference import frozen
from bench.reference.fedgat import Problem, RoundReading, RoundSpec, run_round
from bench.reference.judge import judge

STREAMS = ("graph", "cap", "params", "masks", "run")


def derive_seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds for each input, from the run's ``--seed``."""
    return {name: frozen.fold_in(seed, i) >> 1 for i, name in enumerate(STREAMS, 1)}


class SeededNormals(Sequence):
    """Standard normals of the given shapes on ``device``, the ``i``-th
    drawn when it is read from a generator seeded ``fold_in(seed, i)``: the
    pack's masks, one at a time, the same bits for the same seed."""

    def __init__(self, seed: int, shapes: Sequence[tuple], device):
        self.seed, self.shapes, self.device = seed, list(shapes), torch.device(device)

    def __len__(self) -> int:
        return len(self.shapes)

    def __getitem__(self, i: int) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(frozen.fold_in(self.seed, i) >> 1)
        return torch.randn(self.shapes[i], generator=gen, device=self.device)


def mask_shapes(n: int, d: int, b: int) -> List[tuple]:
    g = 2 * b
    return [(n, d, g), (n, d, g), (n, g, d), (n, g)]


def init_params(model: dict, d_in: int, classes: int, seed: int, device) -> List[Dict]:
    """Uniform(-lim, lim) weights, lim = 0.5 sqrt(6 / (d_in + d_out)) a
    layer (the program's init distribution), drawn in one call on the
    device."""
    shapes = gat_counts.layers(model, d_in, classes)
    sizes = [(h * di * do, h * do, h * do) for h, di, do in shapes]
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    u = torch.rand(sum(map(sum, sizes)), generator=gen, device=device) * 2.0 - 1.0
    out, pos = [], 0
    for (h, di, do), (nw, na, _) in zip(shapes, sizes):
        lim = 0.5 * math.sqrt(6.0 / (di + do))
        W = u[pos:pos + nw].view(h, di, do) * lim
        a1 = u[pos + nw:pos + nw + na].view(h, do) * lim
        a2 = u[pos + nw + na:pos + nw + 2 * na].view(h, do) * lim
        pos += nw + 2 * na
        out.append({"W": W.clone(), "a1": a1.clone(), "a2": a2.clone()})
    return out


def leaves(params: List[Dict]) -> List[torch.Tensor]:
    return [layer[k] for layer in params for k in ("W", "a1", "a2")]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides."""

    seeds: Dict[str, int]
    graph: Dict[str, np.ndarray]
    params0: List[Dict]


def prepare(cell, seed: int, device) -> Inputs:
    seeds = derive_seeds(seed)
    graph = graphgen.make_graph_inputs(cell.config["graph"], seeds["graph"])
    model = cell.config["model"]
    gs = cell.config["graph"]
    params0 = init_params(model, int(gs["feature_dim"]), int(gs["num_classes"]),
                          seeds["params"], device)
    return Inputs(seeds, graph, params0)


def clients_a_round(cell) -> int:
    t = cell.traffic
    return frozen.num_selected(float(t["client_fraction"]), int(t["num_clients"]))


def round_spec(cell, seeds: Dict[str, int]) -> RoundSpec:
    t, priv = cell.traffic, cell.traffic.get("privacy", {})
    if priv.get("secure_agg") and priv.get("secure_agg_mode", "protocol") != "pairwise":
        raise NotImplementedError("the reference follows pairwise masks only")
    n_sel = clients_a_round(cell)
    mcc = t.get("max_concurrent_clients")
    return RoundSpec(
        run_seed=seeds["run"], num_clients=int(t["num_clients"]), beta=float(t["beta"]),
        client_fraction=float(t["client_fraction"]), local_steps=int(t["local_steps"]),
        lr=float(t["lr"]), weight_decay=float(t["weight_decay"]),
        cohort=None if mcc is None else min(n_sel, int(mcc)),
        noise_multiplier=float(priv.get("noise_multiplier", 0.0)),
        clip=float(priv.get("clip", math.inf)), secure_agg=bool(priv.get("secure_agg", False)),
        mask_scale=float(priv.get("mask_scale", 1.0)))


# ---------------------------------------------------------------------------
# The program's side
# ---------------------------------------------------------------------------

@dataclass
class ProgramState:
    graph: Any
    cfg: Any                  # FederatedConfig of a window call
    params0: List[Dict]
    pack: Any
    device: torch.device
    reading: Optional[RoundReading] = None
    window: Optional[Any] = None          # record.WindowRecorder of the window's calls

    def call(self, rounds: Optional[int] = None):
        from repro_torch.federated.trainer import run_federated

        cfg = self.cfg if rounds is None else replace(self.cfg, rounds=rounds)
        return run_federated(self.graph, cfg, device=self.device, params=self.params0,
                             pack=self.pack)


def program_state(cell, inputs: Inputs, device) -> ProgramState:
    """The graph through the program's constructors, the pack for a pack engine,
    and the Trainer's config for a window call."""
    from repro_torch.core.fedgat_model import FedGATConfig, graph_tensors
    from repro_torch.federated.trainer import FederatedConfig
    from repro_torch.graphs.graph import make_graph_from_edges, sample_neighbors
    from repro_torch.privacy import PrivacyConfig

    gs, model, t = cell.config["graph"], cell.config["model"], cell.traffic
    gi = inputs.graph
    g = make_graph_from_edges(gi["features"], gi["labels"], gi["edges"], gi["train_mask"],
                              gi["val_mask"], gi["test_mask"], int(gs["num_classes"]))
    g = sample_neighbors(g, int(gs["neighbor_cap"]), seed=inputs.seeds["cap"])
    mcfg = FedGATConfig(
        hidden=int(model["hidden"]), heads=int(model["heads"]),
        out_heads=int(model["out_heads"]), num_layers=int(model["num_layers"]),
        degree=int(model["degree"]), domain=tuple(float(x) for x in model["domain"]),
        basis=model["basis"], engine=model["engine"], leaky_slope=float(model["leaky_slope"]))
    cfg = FederatedConfig(
        method="fedgat", backend="vmap", num_clients=int(t["num_clients"]),
        beta=float(t["beta"]), rounds=int(cell.settings["rounds_per_call"]),
        local_steps=int(t["local_steps"]), lr=float(t["lr"]),
        weight_decay=float(t["weight_decay"]), aggregator=t.get("aggregator", "fedavg"),
        client_fraction=float(t["client_fraction"]), seed=inputs.seeds["run"], model=mcfg,
        privacy=PrivacyConfig(**t.get("privacy", {})),
        max_concurrent_clients=t.get("max_concurrent_clients"),
        aggregation_mode=t.get("aggregation_mode", "sync"))
    pack = None
    if model["engine"] == "vector":
        from repro_torch.core.fedgat_vector import precompute_vector_pack

        h, nbr_idx, nbr_mask = graph_tensors(g, device)
        masks = SeededNormals(inputs.seeds["masks"],
                              mask_shapes(g.num_nodes, g.feature_dim, g.max_degree), device)
        pack = precompute_vector_pack(None, h, nbr_idx, nbr_mask, masks=masks)
        del h, nbr_idx, nbr_mask
    return ProgramState(g, cfg, inputs.params0, pack, torch.device(device))


def warm_call(state: ProgramState, cell) -> RoundReading:
    """One round through the window's own call, its local steps read."""
    from repro_torch.federated import trainer

    from bench.harness.record import StepRecorder

    with StepRecorder(trainer) as rec:
        result = state.call(rounds=1)
        sync(state.device)
    state.reading = rec.reading(clients_a_round(cell), int(cell.traffic["local_steps"]),
                                result["params"])
    return state.reading


def run_window(state: ProgramState, seconds: float) -> List[Dict]:
    """Whole calls back to back; none starts after ``seconds``. Each call's
    first round is read for the comparison (``state.window``)."""
    from repro_torch.federated import trainer

    from bench.harness.record import WindowRecorder

    calls = []
    state.window = WindowRecorder(trainer, tuple(state.reading.eval_logits.shape), state.device)
    with state.window:
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            state.call()
            sync(state.device)
            b = time.perf_counter()
            calls.append({"start": a, "end": b, "wall_s": b - a, "rounds": state.cfg.rounds})
            if b - t0 >= seconds:
                return calls


def free(state: ProgramState) -> None:
    state.pack = None
    state.graph = None
    gc.collect()
    if state.device.type == "cuda":
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The reference's side
# ---------------------------------------------------------------------------

def reference_problem(cell, inputs: Inputs, device) -> Problem:
    """The inputs in the reference's hands: the capped lists worked out
    again by the frozen rule."""
    gs, gi = cell.config["graph"], inputs.graph
    n = int(gs["num_nodes"])
    nbr_idx, nbr_mask = frozen.capped_neighbor_lists(gi["edges"], n, int(gs["neighbor_cap"]),
                                                     inputs.seeds["cap"])
    dev = torch.device(device)
    return Problem(
        features=torch.as_tensor(gi["features"], device=dev),
        labels=torch.as_tensor(gi["labels"], dtype=torch.int64, device=dev),
        nbr_idx=torch.as_tensor(nbr_idx, dtype=torch.int64, device=dev),
        nbr_mask=torch.as_tensor(nbr_mask, device=dev),
        train_mask=gi["train_mask"], labels_np=gi["labels"], model=cell.config["model"])


class precision:
    """The reference's float32 with TF32 off, or TF32 on for the control."""

    def __init__(self, tf32: bool):
        self.tf32 = tf32

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def reference_round(cell, pr: Problem, inputs: Inputs, *, tf32: bool = False,
                    fault: Optional[str] = None) -> RoundReading:
    with precision(tf32):
        return run_round(pr, leaves(inputs.params0), round_spec(cell, inputs.seeds), fault=fault)


def compare(cell, pr: Problem, inputs: Inputs, prog: RoundReading, ref: RoundReading,
            window: Optional[Any] = None) -> Dict[str, float]:
    """The numbers compared; with ``window`` (a ``WindowRecorder``), the
    window's calls are judged beside the warm call."""
    judged = () if window is None else window.params
    logits = None if window is None else window.logits
    with precision(False):
        return judge(pr, leaves(inputs.params0), prog, ref, judged, logits)


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

@dataclass
class Context:
    """What the per-layer metrics' readers are handed."""

    cell: Any
    calls: List[Dict]
    train_round_s: float
    round_flops: int
    shapes: Dict[str, int]
    profile: Optional[Profile] = None
    profile_steps: int = 0


def shapes_of(cell) -> Dict[str, int]:
    gs, model = cell.config["graph"], cell.config["model"]
    return {"heads": int(model["heads"]), "nodes": int(gs["num_nodes"]),
            "b": int(gs["neighbor_cap"]), "d": int(gs["feature_dim"]),
            "coeffs": int(model["degree"]) + 1}


def round_flops(cell) -> int:
    gs = cell.config["graph"]
    counter = spec.counts(f"fedgat_{cell.config['model']['engine']}")
    return counter.round_flops(cell.config["model"], gs, int(gs["neighbor_cap"]),
                               int(cell.traffic["local_steps"]), clients_a_round(cell))


def measure(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    """Set-up, the window, (with ``trace``) one profiled call, then the
    reference and the comparison. Returns the pieces of the result line."""
    from repro_torch import telemetry

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
