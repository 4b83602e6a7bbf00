"""Cohort-streaming federated rounds: clients decoupled from lanes.

The port of ``repro/federated/cohort.py``. A round's CS(t)-selected
clients are split into *cohorts* of at most
``FederatedConfig.max_concurrent_clients`` clients and streamed through the
local phase cohort by cohort. The round aggregate is carried as a
:class:`~repro_torch.federated.aggregation.RunningAggregate` (weighted sum
plus weight total), so round memory is O(cohort), never O(K).

The streamed schedule is *the same schedule*: per-(round, client) DP noise
seeds and pairwise secure-aggregation masks are derived from the client's
global id as the Trainer's loop derives them, so cohort boundaries are
invisible to the privacy stack, and sync-mode metrics agree with the
loop up to float re-association.

Two aggregation modes (``FederatedConfig.aggregation_mode``):

  sync     — the server waits for every cohort; the finished running mean
             is the round's FedAvg/FedAdam aggregate.
  buffered — cohort c's contribution is discounted by the staleness
             weight λ(c) = (1 + c)^(-staleness_power), and mid-round churn
             is tolerated (``churn_drop_rate`` / ``churn_join_rate``), with
             pairwise masks keyed on the round's *actual* participation
             row. With ``staleness_power=0`` and no churn, buffered mode
             equals sync mode bit for bit.

Backends differ only in how many lanes a cohort has:

  vmap      — ``max_concurrent_clients`` (or the round's participants);
  shard_map — one lane per device, as in the reference, and a process
              drives one device: one lane. The run's mesh is that lane
              (``{"axis_names": ["lanes"], "axis_sizes": [1], ...}``).
              Cohorts stream in a single process only; under a process
              group of more ranks the reference's ``NotImplementedError``
              is raised (federated/sharded.py runs the multi-process
              rounds).

The round planning (:func:`plan_round`, :func:`plan_rounds`) and the mask
staging are host numpy and give the reference's plans bit for bit. In the
reference a cohort is one jitted vmap (or shard_map) over its lanes,
padding lanes included; here a cohort is a loop over its *live* lanes,
one local phase each, as in the Trainer's loop. A padding lane's weight is
0 and its optimizer-state scatter drops in the reference, so skipping it
changes no result. Staged masks move to the run's device per cohort and
are memoised for at most ``capacity`` cohorts (mask memory
O(lanes · N · B)); the per-client optimizer bank stays on the device.

With ``secure_agg_mode="protocol"`` each live lane's update goes through
the host-side protocol (privacy/secure_agg.py) on either backend: the
λ-scaled delta is quantized and masked in the field, and the server's
unmasking (with dropout recovery) yields the round mean. No params are
gathered across lanes on that path.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch._device import DeviceLike, process_count, resolve_device
from repro_torch._tree import tree_map
from repro_torch.federated.aggregation import (
    fedadam_update,
    running_init,
    running_mean,
    running_update,
)
from repro_torch.federated.partition import Partition, stage_cohort_masks
from repro_torch.graphs.graph import Graph
from repro_torch.optim.adamw import adam_init
from repro_torch.privacy import (
    DropoutRecoveryError,
    SecureAggRound,
    add_client_mask,
    client_round_key,
    flatten_pytree,
    mask_base_key,
    noise_base_key,
)

AGGREGATION_MODES = ("sync", "buffered")

# Dedicated host-side RNG stream for buffered-mode churn: sync runs never
# draw from it, so enabling churn cannot perturb CS(t) or the privacy
# streams.
_CHURN_STREAM = 0xC0C0


def cohort_active(cfg) -> bool:
    """True when the run goes through the cohort driver: the cohort size
    is set, buffered aggregation was requested, or the secure-aggregation
    protocol is on (its key agreement and field unmasking run host-side,
    per cohort)."""
    return (
        cfg.max_concurrent_clients is not None
        or cfg.aggregation_mode != "sync"
        or cfg.privacy.secure_agg_protocol
    )


def cohort_lanes(cfg, backend: str = "vmap", num_devices: Optional[int] = None) -> int:
    """Lanes per cohort: ``max_concurrent_clients`` caps it, and a cohort
    never needs more lanes than the round has participants; the shard_map
    backend also caps it at the device count (one lane per device), which
    defaults to 1: a process drives one device."""
    from repro_torch.federated.trainer import num_selected

    lanes = num_selected(cfg)
    if cfg.max_concurrent_clients is not None:
        lanes = min(lanes, cfg.max_concurrent_clients)
    if backend == "shard_map":
        lanes = min(lanes, num_devices if num_devices else 1)
    return max(1, lanes)


# ---------------------------------------------------------------------------
# Host-side round planning (CS(t) -> cohorts, churn, staleness)
# ---------------------------------------------------------------------------

class RoundPlan(NamedTuple):
    """One round's cohort schedule, precomputed host-side."""

    ids: np.ndarray          # (num_cohorts, lanes) int32 client ids; pad = K
    weights: np.ndarray      # (num_cohorts, lanes) float32 1=live, 0=pad/drop
    sel_row: np.ndarray      # (K,) float32 ACTUAL participation (after churn)
    staleness: np.ndarray    # (num_cohorts,) float32 λ per landing cohort
    joined: int              # clients that joined mid-round (buffered churn)
    dropped: int             # selected clients that dropped mid-round


def plan_round(
    cfg,
    chosen_row: np.ndarray,
    lanes: int,
    rng: Optional[np.random.Generator],
) -> RoundPlan:
    """Split one round's CS(t)-selected clients into cohorts of ``lanes``.

    Padding lanes carry the out-of-range id K with weight 0.
    """
    K = cfg.num_clients
    participants = [int(c) for c in np.asarray(chosen_row).reshape(-1)]
    joined = dropped = 0
    if cfg.aggregation_mode == "buffered" and rng is not None and (
        cfg.churn_drop_rate > 0 or cfg.churn_join_rate > 0
    ):
        keep = rng.random(len(participants)) >= cfg.churn_drop_rate
        if not keep.any():                      # a round never goes empty
            keep[int(rng.integers(len(participants)))] = True
        dropped = int((~keep).sum())
        participants = [p for p, k in zip(participants, keep) if k]
        others = np.setdiff1d(np.arange(K), np.asarray(chosen_row))
        if others.size and cfg.churn_join_rate > 0:
            join = others[rng.random(others.size) < cfg.churn_join_rate]
            joined = int(join.size)
            participants.extend(int(j) for j in join)
    sel_row = np.zeros(K, np.float32)
    sel_row[participants] = 1.0
    n_cohorts = -(-len(participants) // lanes)
    ids = np.full((n_cohorts, lanes), K, np.int32)
    weights = np.zeros((n_cohorts, lanes), np.float32)
    for c in range(n_cohorts):
        chunk = participants[c * lanes : (c + 1) * lanes]
        ids[c, : len(chunk)] = chunk
        weights[c, : len(chunk)] = 1.0
    if cfg.aggregation_mode == "buffered":
        lam = (1.0 + np.arange(n_cohorts, dtype=np.float32)) ** (
            -float(cfg.staleness_power)
        )
    else:
        lam = np.ones(n_cohorts, np.float32)
    return RoundPlan(
        ids=ids, weights=weights, sel_row=sel_row, staleness=lam,
        joined=joined, dropped=dropped,
    )


def plan_rounds(cfg, chosen_sched: np.ndarray, lanes: int) -> List[RoundPlan]:
    """Every round's cohort plan (churn RNG advanced round by round)."""
    rng = None
    if cfg.aggregation_mode == "buffered" and (
        cfg.churn_drop_rate > 0 or cfg.churn_join_rate > 0
    ):
        rng = np.random.default_rng(cfg.seed + _CHURN_STREAM)
    return [plan_round(cfg, chosen_sched[t], lanes, rng) for t in range(cfg.rounds)]


class _CohortStager:
    """Memoised per-cohort mask staging: stacks ONLY the active cohort's
    client masks (O(lanes · N · B)) and moves them to ``device``, with an
    LRU memo of at most ``capacity`` cohorts (client_fraction == 1 repeats
    the same cohorts every round)."""

    def __init__(self, g: Graph, part: Partition, lanes: int,
                 per_client_nb: bool, capacity: int = 32, device: DeviceLike = "cpu"):
        self.g, self.part, self.lanes = g, part, lanes
        self.per_client_nb = per_client_nb
        self.capacity = max(capacity, 2)
        self.device = torch.device(device)
        self._memo: "OrderedDict[tuple, tuple]" = OrderedDict()

    def __call__(self, live_ids: Sequence[int]):
        key = tuple(int(i) for i in live_ids)
        hit = self._memo.get(key)
        if hit is not None:
            self._memo.move_to_end(key)
            return hit
        nb, tr = stage_cohort_masks(
            self.g, self.part, key, self.lanes, neighbor=self.per_client_nb
        )
        staged = (None if nb is None else torch.as_tensor(nb, device=self.device),
                  torch.as_tensor(tr, device=self.device))
        self._memo[key] = staged
        while len(self._memo) > self.capacity:
            self._memo.popitem(last=False)
        return staged


# ---------------------------------------------------------------------------
# The streaming round driver
# ---------------------------------------------------------------------------

def _finalize_protocol_round(
    sar: SecureAggRound,
    cfg,
    t: int,
    dim: int,
    priv,
    lam_by: Dict[int, float],
    vec_by: Dict[int, np.ndarray],
    gvec: np.ndarray,
    unflatten: Callable,
):
    """Server side of the round: unmask, recover dropouts, decode the mean.

    When seed reconstruction is impossible (survivors below the Shamir
    threshold) the round degrades: the failure is counted and the protocol
    re-runs among the survivors under a fresh ``attempt`` index (a re-mask
    and re-sum of the deltas in hand, as the real protocol's retry round).
    """
    survivors = sorted(lam_by)
    try:
        total, info = sar.finalize(survivors)
        if info["dropped"]:
            telemetry.counter("privacy.secure_agg.recovered_seeds").inc(
                info["recovered_seeds"]
            )
            telemetry.event(
                "privacy.secure_agg.recovered", round=t, dropped=info["dropped"]
            )
    except DropoutRecoveryError as exc:
        telemetry.counter("privacy.secure_agg.recovery_failures").inc()
        telemetry.event("privacy.secure_agg.degraded", round=t, reason=str(exc))
        retry = SecureAggRound(
            cfg.seed, t, survivors, dim,
            quant_bits=priv.quant_bits, quant_range=priv.quant_range,
            threshold=None, attempt=1,
        )
        for cid in survivors:
            retry.accumulate(cid, retry.client_payload(cid, vec_by[cid]))
        total, info = retry.finalize(survivors)
    if info["saturated"]:
        telemetry.counter("privacy.secure_agg.saturated_elements").inc(
            info["saturated"]
        )
    wsum = sum(lam_by.values())
    return unflatten(gvec + total / wsum)


def run_cohort_rounds(
    g: Graph,
    cfg,
    backend: str = "vmap",
    *,
    device: DeviceLike = None,
    params: Optional[Any] = None,
    pack: Optional[Any] = None,
) -> Dict[str, Any]:
    """Cohort-streamed paper Algorithm 2 on ``device`` (default ``cuda``),
    with the lanes of ``backend`` (:func:`cohort_lanes`). ``params`` and
    ``pack`` are the initial params and the pre-communicated pack, as for
    :meth:`~repro_torch.federated.trainer.Trainer.run`."""
    from repro_torch.federated.trainer import (
        ClientOptimizers,
        Mesh,
        build_result,
        record_epsilon,
        selection_schedule,
        setup_run,
    )

    if backend not in ("vmap", "shard_map"):
        raise ValueError(f"unknown backend {backend!r}")
    dev = resolve_device(device)
    K = cfg.num_clients
    t0 = time.time()
    run = setup_run(cfg, g, dev, params, pack)
    gparams = run.params

    cohort_report: Dict[str, Any] = {
        "mode": cfg.aggregation_mode,
        "max_concurrent_clients": cfg.max_concurrent_clients,
        "staleness_power": (
            float(cfg.staleness_power)
            if cfg.aggregation_mode == "buffered" else 0.0
        ),
        "joined": 0,
        "dropped": 0,
    }
    if cfg.rounds == 0:
        cohort_report.update(lanes=0, cohorts_per_round=0)
        return build_result(
            cfg=cfg, params=gparams, val_curve=[], test_curve=[],
            part=run.part, g=g, seconds=time.time() - t0, cohort=cohort_report,
        )

    lanes = cohort_lanes(cfg, backend)
    mesh = None
    if backend == "shard_map":
        if process_count() > 1:
            raise NotImplementedError(
                "cohort streaming runs on a single-process mesh; multi-"
                "process runs keep the one-client-per-shard layout (unset "
                "max_concurrent_clients / use aggregation_mode='sync', and "
                "with secure aggregation use secure_agg_mode='pairwise' — "
                "the in-jit masks that cancel in the cross-process psum)"
            )
        mesh = Mesh("lanes", lanes, 1, dev)
    protocol = cfg.privacy.secure_agg_protocol
    bank = ClientOptimizers(gparams, K)
    server_state = adam_init(gparams)

    _, chosen_sched = selection_schedule(cfg)
    plans = plan_rounds(cfg, chosen_sched, lanes)
    cohort_report["lanes"] = lanes
    cohort_report["cohorts_per_round"] = max(p.ids.shape[0] for p in plans)
    cohort_report["joined"] = sum(p.joined for p in plans)
    cohort_report["dropped"] = sum(p.dropped for p in plans)
    # Churn accounting in the process-wide registry (always on).
    telemetry.counter("federated.cohort.joined").inc(cohort_report["joined"])
    telemetry.counter("federated.cohort.dropped").inc(cohort_report["dropped"])

    stager = _CohortStager(
        g, part=run.part, lanes=lanes, per_client_nb=cfg.method == "distgat",
        capacity=max(8, 2 * plans[0].ids.shape[0]), device=dev,
    )
    shared_nb = torch.as_tensor(g.nbr_mask, device=dev)
    priv = cfg.privacy
    noise_base, mask_base = noise_base_key(cfg.seed), mask_base_key(cfg.seed)
    if protocol:
        gvec0, unflatten = flatten_pytree(gparams)
        dim = int(gvec0.size)

    val_curve: List[float] = []
    test_curve: List[float] = []
    for t in range(cfg.rounds):
        plan = plans[t]
        agg = running_init(gparams)
        g_round = gparams              # every cohort dispatches from here
        if protocol:
            # Key agreement and secret sharing over the ADVERTISED cohort,
            # the pre-churn CS(t) selection: clients that later drop are
            # the ones whose masks the recovery phase removes.
            with telemetry.span("secure_agg_setup", round=t):
                advertised = sorted({int(c) for c in np.asarray(chosen_sched[t]).reshape(-1)})
                sar = SecureAggRound(
                    cfg.seed, t, advertised, dim,
                    quant_bits=priv.quant_bits, quant_range=priv.quant_range,
                    threshold=priv.secure_agg_threshold,
                )
                gvec = flatten_pytree(g_round)[0]
            lam_by: Dict[int, float] = {}
            vec_by: Dict[int, np.ndarray] = {}
        with telemetry.span("round", round=t, backend=backend, cohorts=int(plan.ids.shape[0])):
            for c in range(plan.ids.shape[0]):
                ids, w = plan.ids[c], plan.weights[c]
                live = np.nonzero(w > 0)[0]
                lam_c = float(plan.staleness[c])
                with telemetry.span("cohort", cohort=c, live=int(live.size)):
                    with telemetry.span("staging"):
                        nb, tr = stager(ids[live])
                    outs = []
                    for lane in live.tolist():
                        cid = int(ids[lane])
                        with telemetry.span("step", client=cid):
                            p = bank.local_phase(
                                run.local_update, g_round, cid,
                                shared_nb if nb is None else nb[lane], tr[lane],
                                client_round_key(noise_base, t, cid),
                            )
                        if protocol:
                            # Client side of the protocol: the λ-scaled
                            # delta is quantized and masked; only the field
                            # payload reaches the server's sum.
                            with telemetry.span("host_transfer"):
                                cvec = flatten_pytree(p)[0]
                            with telemetry.span("secure_agg_mask"):
                                delta = lam_c * (cvec - gvec)
                                sar.accumulate(cid, sar.client_payload(cid, delta))
                                lam_by[cid] = lam_c
                                vec_by[cid] = delta
                        elif priv.secure_agg:
                            outs.append(add_client_mask(
                                mask_base, t, cid, plan.sel_row, p, priv.mask_scale))
                        else:
                            outs.append(p)
                    if outs:
                        with telemetry.span("aggregation_fold"):
                            agg = running_update(
                                agg, tree_map(lambda *ps: torch.stack(ps), *outs),
                                w[live], scale=plan.staleness[c],
                            )
            with telemetry.span("aggregate"):
                if protocol:
                    mean = _finalize_protocol_round(
                        sar, cfg, t, dim, priv, lam_by, vec_by, gvec, unflatten
                    )
                else:
                    mean = running_mean(agg)
                if cfg.aggregator == "fedadam":
                    gparams, server_state = fedadam_update(
                        g_round, mean, server_state, cfg.server_lr)
                else:
                    gparams = mean
            with telemetry.span("evaluate"):
                va, ta = run.evaluate(gparams)
        val_curve.append(va)
        test_curve.append(ta)
        record_epsilon(cfg, t)

    return build_result(
        cfg=cfg, params=gparams, val_curve=val_curve,
        test_curve=test_curve, part=run.part, g=g, seconds=time.time() - t0,
        mesh=mesh, cohort=cohort_report,
    )
