"""shard_map federated backend: clients laid over the ranks of a process group.

The port of ``repro/federated/sharded.py``, the paper's communication
pattern: each party holds its own clients' state, and the only
collectives crossing clients are

  * the one pre-training communication (the pack), computed identically
    by every rank from the run's seed,
  * one weighted sum a round, a single ``all_reduce(SUM)`` over a flat
    float32 buffer of every parameter leaf and the weight total
    (FedAvg / FedProx / the client mean feeding server-side FedAdam), and
  * a two-scalar ``all_reduce`` carrying the round's evaluation, which
    only rank 0 computes.

No feature tensors cross clients during training.

A torch process drives one device, so the reference's mesh of devices
becomes the ranks of a ``torch.distributed`` process group
(launch/multiprocess.py stands them up): with P ranks, K must divide by
P and rank p hosts the contiguous block ``[p·K/P, (p+1)·K/P)``
(:func:`client_layout`). Each rank builds only its own clients' masks, on
its device, and runs their local phases one after another from the
replicated global params. CS(t) selection, DP noise seeds and pairwise
secure-aggregation masks are keyed by the *global* client id and the
global ``selection_schedule`` row, so the masks cancel in the global sum
and the trajectory does not depend on the layout. An unselected client
runs no local phase and keeps its Adam state. fedadam's server state is
replicated on every rank; since ``all_reduce`` hands every rank the same
bits, the replicas never diverge and the ranks end with bit-identical
params.

A single process is a one-device mesh and follows the reference's rule
for fewer devices than clients: it streams one-lane cohorts
(federated/cohort.py). The secure-aggregation ``protocol`` and the other
cohort knobs run in the cohort driver, which is single-process; across
processes the pairwise masks are the supported mode.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import telemetry
from repro_torch._device import DeviceLike, process_count, resolve_device
from repro_torch._tree import tree_leaves, tree_unflatten
from repro_torch.federated.aggregation import fedadam_update
from repro_torch.federated.partition import (
    ClientSubgraph,
    Partition,
    client_neighbor_masks,
    client_subgraph,
    client_train_masks,
)
from repro_torch.federated.trainer import (
    ClientOptimizers,
    FederatedConfig,
    Mesh,
    build_result,
    run_federated,
    selection_schedule,
    setup_run,
)
from repro_torch.graphs.graph import Graph
from repro_torch.optim.adamw import adam_init
from repro_torch.privacy import add_client_mask, client_round_key, mask_base_key, noise_base_key


class ClientLayout(NamedTuple):
    """Which clients this process hosts: rank ``rank`` of
    ``num_processes`` hosts the contiguous block
    ``[rank·K/P, (rank+1)·K/P)``."""

    num_clients: int
    rank: int
    num_processes: int

    @property
    def hosted(self) -> range:
        per = self.num_clients // self.num_processes
        return range(self.rank * per, (self.rank + 1) * per)


def client_layout(num_clients: int) -> ClientLayout:
    """The client axis over the ranks of the default process group (one
    rank, and all K clients, without one)."""
    nproc = process_count()
    if num_clients % nproc:
        raise ValueError(
            f"num_clients={num_clients} must divide evenly over "
            f"{nproc} processes (every process hosts an equal client block)"
        )
    return ClientLayout(num_clients, dist.get_rank() if nproc > 1 else 0, nproc)


def addressable_clients(layout: ClientLayout) -> list:
    """Client ids this process hosts — the set it is allowed to load data
    for."""
    return list(layout.hosted)


def process_client_subgraphs(
    g: Graph, part: Partition, layout: ClientLayout, hops: int = 1
) -> Dict[int, ClientSubgraph]:
    """Per-process graph loading: the local subgraph (owned nodes +
    ``hops``-hop halo) of every client this process hosts, extracted by CSR
    frontier expansion; nothing belonging to another process's clients is
    materialised."""
    return {k: client_subgraph(g, part, k, hops) for k in addressable_clients(layout)}


def _client_mask_builders(cfg: FederatedConfig, g: Graph, part: Partition):
    """Per-client (nb_mask, tr_mask) builders mirroring
    :func:`~repro_torch.federated.trainer.client_masks` one client at a
    time."""
    if cfg.method == "distgat":
        nb = lambda k: client_neighbor_masks(g, part, clients=[k])[0]  # noqa: E731
    else:
        nb = lambda k: g.nbr_mask  # noqa: E731
    tr = lambda k: client_train_masks(g, part, clients=[k])[0]  # noqa: E731
    return nb, tr


def _sum_over_ranks(buf: torch.Tensor) -> torch.Tensor:
    if process_count() > 1:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf


def _run_shard_map(
    g: Graph,
    cfg: FederatedConfig,
    *,
    device: DeviceLike = None,
    params: Optional[Any] = None,
    pack: Optional[Any] = None,
) -> Dict[str, Any]:
    """FedGAT/DistGAT/FedGCN rounds with clients over the process group's
    ranks; ``params`` and ``pack`` as for
    :meth:`~repro_torch.federated.trainer.Trainer.run`."""
    from repro_torch.federated.cohort import cohort_active, run_cohort_rounds

    dev = resolve_device(device)
    K = cfg.num_clients
    if cohort_active(cfg):
        return run_cohort_rounds(g, cfg, "shard_map", device=dev, params=params, pack=pack)
    if cfg.rounds > 0 and process_count() <= 1 and K > 1:
        # More clients than devices: one process drives one device, so
        # stream one-lane cohorts, as the reference does.
        return run_cohort_rounds(g, cfg, "shard_map", device=dev, params=params, pack=pack)

    t0 = time.time()
    run = setup_run(cfg, g, dev, params, pack)
    if cfg.rounds == 0:
        return build_result(
            cfg=cfg, params=run.params, val_curve=[], test_curve=[],
            part=run.part, g=g, seconds=time.time() - t0,
        )

    layout = client_layout(K)
    hosted = addressable_clients(layout)
    nb_build, tr_build = _client_mask_builders(cfg, g, run.part)
    nb_masks = [torch.as_tensor(nb_build(k), device=dev) for k in hosted]
    tr_masks = [torch.as_tensor(tr_build(k), device=dev) for k in hosted]
    bank = ClientOptimizers(run.params, len(hosted))
    server_state = adam_init(run.params)
    sel, _ = selection_schedule(cfg)
    priv = cfg.privacy
    noise_base, mask_base = noise_base_key(cfg.seed), mask_base_key(cfg.seed)

    gparams = run.params
    val_curve, test_curve = [], []
    with telemetry.span("rounds_scan", rounds=cfg.rounds, backend="shard_map"):
        for t in range(cfg.rounds):
            partial = [torch.zeros_like(p) for p in tree_leaves(gparams)]
            weight = 0.0
            for i, k in enumerate(hosted):
                w = float(sel[t, k])
                if w == 0.0:
                    continue
                p = bank.local_phase(run.local_update, gparams, i, nb_masks[i], tr_masks[i],
                                     client_round_key(noise_base, t, k))
                if priv.secure_agg:
                    # A masked update: the pairwise masks cancel only in
                    # the global sum.
                    p = add_client_mask(mask_base, t, k, sel[t], p, priv.mask_scale)
                partial = [acc + w * leaf for acc, leaf in zip(partial, tree_leaves(p))]
                weight += w
            # The only training-time collective across clients: every leaf
            # and the weight total in one buffer.
            buf = torch.cat([x.reshape(-1) for x in partial]
                            + [torch.full((1,), weight, dtype=torch.float32, device=dev)])
            buf = _sum_over_ranks(buf)
            mean_flat = buf[:-1] / buf[-1]
            mean, offset = [], 0
            for leaf in partial:
                mean.append(mean_flat[offset:offset + leaf.numel()].view_as(leaf))
                offset += leaf.numel()
            mean = tree_unflatten(gparams, mean)
            if cfg.aggregator == "fedadam":
                gparams, server_state = fedadam_update(gparams, mean, server_state,
                                                       cfg.server_lr)
            else:
                gparams = mean
            # The global params are replicated, so rank 0 alone evaluates
            # and the others add zeros.
            va, ta = run.evaluate(gparams) if layout.rank == 0 else (0.0, 0.0)
            scores = _sum_over_ranks(torch.tensor([va, ta], dtype=torch.float64, device=dev))
            val_curve.append(float(scores[0]))
            test_curve.append(float(scores[1]))
    return build_result(
        cfg=cfg, params=gparams, val_curve=val_curve, test_curve=test_curve,
        part=run.part, g=g, seconds=time.time() - t0,
        mesh=Mesh("clients", K, layout.num_processes, dev),
    )


def run_federated_sharded(g: Graph, cfg: FederatedConfig, **kwargs) -> Dict[str, Any]:
    """Backwards-compatible wrapper for the shard_map backend (``device``,
    ``params`` and ``pack`` as for ``run_federated``)."""
    return run_federated(g, cfg, backend="shard_map", **kwargs)
