"""Federated training (paper Algorithm 2), vmap and shard_map backends.

The port of ``repro/federated/trainer.py``. What distinguishes clients is
(a) which training labels they hold and (b) which edges they may see:
FedGAT/FedGCN clients see cross-client information only through the
pre-training communication, DistGAT clients have cross-client edges
dropped. Each round the selected clients run local Adam steps from the
global params, then FedAvg/FedProx/FedAdam aggregates them.

Two backends realise the same schedule (``FederatedConfig.backend``):

  vmap       — the reference stacks clients on a batch axis; here it is a
               Python loop over the round's chosen clients, in ``chosen``
               order: the CUDA kernels are launched through ``ctypes``
               inside an ``autograd.Function``, which has no
               ``torch.func.vmap`` rule, and a loop keeps one client's
               activations on the card at a time.
  shard_map  — the paper's communication pattern (federated/sharded.py):
               a process drives one device, the ranks of a
               ``torch.distributed`` process group stand for the
               reference's mesh, each rank hosts a block of clients, and
               one ``all_reduce`` a round aggregates. In one process it
               streams one-lane cohorts, as the reference does with fewer
               devices than clients.

The schedule, the partition and the update math are the reference's, so
the two packages' trajectories agree given the same initial params. Every
result carries ``mesh`` (:func:`mesh_description`, ``None`` for vmap) and
a run ``manifest`` (telemetry/manifest.py).

Supported methods:
  fedgat   — the paper's algorithm (engine: any registered engine; the
             default ``matrix`` is the paper's own)
  distgat  — GAT, cross-client edges dropped, FedAvg (baseline)
  fedgcn   — FedGCN: exact pre-communicated aggregates, i.e. a GCN on the
             full graph with local losses
  gat/gcn  — centralised baselines via train_centralized()

Under the pack engines (``matrix``, ``vector``) :func:`build_forward`
runs the one pre-training communication round: the pack is drawn from a
generator on the run's device, seeded from ``cfg.seed`` through a
splitmix64 derivation (:func:`pack_generator`), a stream separate from the
parameter initialisation's. ``pack=`` feeds a pack built elsewhere instead
(the reference's, or one built on another device).

Cohort streaming (``max_concurrent_clients``, buffered aggregation,
churn, and the secure-aggregation ``protocol``) runs through
:func:`repro_torch.federated.cohort.run_cohort_rounds`. The privacy stack
is wired as in the reference: DP clipping and noise at the end of
:func:`make_local_update` (noise drawn on a CPU generator, so the card and
the CPU add the same noise), pairwise masks in the round step, pack noise
in :func:`build_forward`.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import telemetry
from repro_torch._device import DeviceLike, resolve_device
from repro_torch._rng import fold_in, generator
from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.core.engine import get_engine
from repro_torch.core.fedgat_model import FedGAT, FedGATConfig, graph_tensors, params_from_numpy
from repro_torch.core.gat import masked_accuracy, masked_cross_entropy
from repro_torch.core.gcn import gcn_forward_nbr, init_gcn_params, normalized_nbr_coeffs
from repro_torch.federated import comm as comm_mod
from repro_torch.federated.aggregation import fedadam_server, fedavg, fedprox_grad
from repro_torch.federated.cohort import AGGREGATION_MODES, cohort_active, run_cohort_rounds
from repro_torch.federated.partition import (
    Partition,
    client_neighbor_masks,
    client_train_masks,
    dirichlet_partition,
)
from repro_torch.graphs.graph import Graph
from repro_torch.optim.adamw import AdamState, adam_init, adam_update
from repro_torch.privacy import (
    PrivacyConfig,
    add_client_mask,
    client_round_key,
    compute_epsilon,
    make_dp_transform,
    mask_base_key,
    node_influence_bound,
    noise_base_key,
    noisy_pack,
    pack_noise_key,
    privacy_report,
)
from repro_torch.telemetry.manifest import build_manifest

BACKENDS = ("vmap", "shard_map")
Tree = Any


@dataclass(frozen=True)
class FederatedConfig:
    method: str = "fedgat"            # fedgat | distgat | fedgcn
    backend: str = "vmap"             # vmap | shard_map
    num_clients: int = 10
    beta: float = 1.0                 # Dirichlet: 1 = non-iid, 1e4 = iid
    rounds: int = 60
    local_steps: int = 3
    lr: float = 0.01
    weight_decay: float = 1e-3
    aggregator: str = "fedavg"        # fedavg | fedprox | fedadam
    prox_mu: float = 0.01
    server_lr: float = 0.05
    client_fraction: float = 1.0      # Algorithm 2's CS(t) subset sampling
    seed: int = 0
    model: FedGATConfig = field(default_factory=FedGATConfig)
    gcn_hidden: int = 16
    privacy: PrivacyConfig = field(default_factory=PrivacyConfig)
    # Cohort streaming (federated/cohort.py): decouple clients from lanes.
    max_concurrent_clients: Optional[int] = None   # cohort size cap (None = one lane per client)
    aggregation_mode: str = "sync"    # sync | buffered (staleness-weighted)
    staleness_power: float = 0.5      # buffered: λ(s) = (1 + s)^(-power)
    churn_drop_rate: float = 0.0      # buffered: P(selected client drops mid-round)
    churn_join_rate: float = 0.0      # buffered: P(unselected client joins mid-round)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def pack_released(cfg: FederatedConfig) -> bool:
    """True when this run pre-communicates a pack (the payload pack noise
    noises): a fedgat/distgat method whose effective engine needs one."""
    if cfg.method not in ("fedgat", "distgat"):
        return False
    return get_engine(method_model_config(cfg).engine).needs_pack


def method_model_config(cfg: FederatedConfig) -> FedGATConfig:
    """The model config a federated method actually trains: DistGAT is the
    same architecture with the exact layer-1 engine."""
    if cfg.method == "distgat":
        return replace(cfg.model, engine="exact")
    return cfg.model


def param_tree(params) -> List[Dict[str, torch.Tensor]]:
    """Parameters (an ``nn.ModuleList`` of ``ParameterDict``s or a list of
    mappings of tensors) as a list of dicts of detached tensors."""
    return [{k: v.detach() for k, v in layer.items()} for layer in params]


PACK_STREAM = 0x7061636B      # "pack": the pack generator's stream under the run's seed


def pack_generator(seed: int, device: DeviceLike) -> torch.Generator:
    """The generator a run seeded ``seed`` draws its pack from, on
    ``device``: a splitmix64 derivation of the seed, so it is a stream apart
    from the parameter initialisation's ``torch.Generator().manual_seed(seed)``."""
    return generator(fold_in(seed, PACK_STREAM), device)


def build_forward(
    cfg: FederatedConfig, g: Graph, device: torch.device, pack: Optional[Any] = None,
) -> Tuple[Callable, Callable]:
    """Returns ``(init_fn(gen) -> params, forward(params, nbr_mask) -> logits)``.
    The graph's arrays go to ``device`` here, once for the run. For
    fedgat/distgat the one-shot pack is communicated here: ``pack`` when
    given (moved to ``device``), else precomputed under
    :func:`pack_generator`. With ``privacy.pack_noise_multiplier > 0`` the
    stored pack is replaced by its noised release (privacy/pack_dp.py),
    drawn on the pack's device, and the clean pack is dropped."""
    if cfg.method in ("fedgat", "distgat"):
        model = FedGAT(method_model_config(cfg), device=device)
        if pack is not None:
            model.install_pack(pack, g)
        else:
            model.precommunicate(pack_generator(cfg.seed, model.device), g)
        if cfg.privacy.pack_noise_multiplier > 0 and model.pack is not None:
            # Node-level accounting calibrates to the node-influence bound
            # of the degree-capped neighbour lists; edge-level (the
            # default) to a single neighbour term.
            node = cfg.privacy.dp_granularity == "node"
            model.pack = noisy_pack(
                pack_noise_key(cfg.seed), model.pack, g.features,
                cfg.privacy.pack_noise_multiplier,
                granularity="node" if node else "edge",
                node_influence=node_influence_bound(g) if node else 1,
            )

        def init_fn(gen):
            return param_tree(model.init(gen, g))

        def forward(params, nb_mask):
            return model.apply(params, g, nb_mask)

        return init_fn, forward
    if cfg.method == "fedgcn":
        h, nbr_idx, _ = graph_tensors(g, device)
        coef = torch.as_tensor(normalized_nbr_coeffs(g.nbr_idx, g.nbr_mask), device=device)

        def init_fn(gen):
            return init_gcn_params(gen, g.feature_dim, cfg.gcn_hidden, g.num_classes,
                                   device=device)

        def forward(params, nb_mask):  # nb_mask unused: aggregates are exact
            return gcn_forward_nbr(params, h, nbr_idx, coef)

        return init_fn, forward
    raise ValueError(f"unknown federated method {cfg.method!r}")


def client_masks(cfg: FederatedConfig, g: Graph, part: Partition, device: torch.device):
    """Per-client (edge-visibility, train-label) masks: (K, N, B), (K, N).
    Methods whose clients all see the full graph get one mask expanded
    over K (no K-fold copy)."""
    K = cfg.num_clients
    if cfg.method == "distgat":
        nb_masks = torch.as_tensor(client_neighbor_masks(g, part), device=device)
    else:
        nb_masks = torch.as_tensor(g.nbr_mask, device=device).expand((K,) + g.nbr_mask.shape)
    return nb_masks, torch.as_tensor(client_train_masks(g, part), device=device)


def make_loss_fn(forward: Callable, labels: torch.Tensor) -> Callable:
    """Client objective: masked CE on the client's training labels under
    its edge-visibility mask."""

    def loss_fn(params, nb_mask, tr_mask):
        return masked_cross_entropy(forward(params, nb_mask), labels, tr_mask)

    return loss_fn


def grad_of(loss_fn: Callable, params: Tree, *args) -> Tree:
    """Gradient of ``loss_fn(params, *args)`` with respect to every leaf of
    ``params``, as a tree of the same structure."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), *args)
    return tree_unflatten(params, list(torch.autograd.grad(loss, leaves)))


def make_local_update(loss_fn: Callable, cfg: FederatedConfig) -> Callable:
    """One client's local phase: ``cfg.local_steps`` Adam steps from the
    global params, with the FedProx pull under ``aggregator="fedprox"``.

    When ``cfg.privacy`` enables DP, the client's update delta is clipped
    and noised (privacy/dp.py) under the per-(round, client) ``noise_seed``
    before it leaves the local phase. With DP off the seed is unused and
    the computation is the privacy-free one, bit for bit."""
    priv = cfg.privacy
    dp = make_dp_transform(priv, num_selected(cfg)) if priv.dp_enabled else None

    def local_update(gparams, opt_state, nb_mask, tr_mask, noise_seed):
        params = gparams
        for _ in range(cfg.local_steps):
            grads = grad_of(loss_fn, params, nb_mask, tr_mask)
            if cfg.aggregator == "fedprox":
                grads = fedprox_grad(params, gparams, grads, cfg.prox_mu)
            params, opt_state = adam_update(
                grads, opt_state, params, cfg.lr, weight_decay=cfg.weight_decay
            )
        if dp is not None:
            params = dp(noise_seed, gparams, params)
        return params, opt_state

    return local_update


def num_selected(cfg: FederatedConfig) -> int:
    """Participants per round under Algorithm 2's CS(t), in [1, K]:
    half-up rounding (floor(x + 0.5)), clamped to K, as the reference."""
    n = int(math.floor(cfg.client_fraction * cfg.num_clients + 0.5))
    return min(cfg.num_clients, max(1, n))


def selection_schedule(cfg: FederatedConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Algorithm 2's CS(t) for the whole run, from the reference's numpy
    stream: ``(sel (rounds, K) float32 0/1, chosen (rounds, n_sel) int32)``."""
    K = cfg.num_clients
    n_sel = num_selected(cfg)
    if n_sel >= K:
        sel = np.ones((cfg.rounds, K), np.float32)
        chosen = np.broadcast_to(np.arange(K, dtype=np.int32), (cfg.rounds, K))
        return sel, np.ascontiguousarray(chosen)
    rng = np.random.default_rng(cfg.seed + 1)
    sel = np.zeros((cfg.rounds, K), np.float32)
    chosen = np.zeros((cfg.rounds, n_sel), np.int32)
    for t in range(cfg.rounds):
        c = rng.choice(K, size=n_sel, replace=False)
        sel[t, c] = 1.0
        chosen[t] = c
    return sel, chosen


def best_metrics(val_curve: Sequence[float], test_curve: Sequence[float]) -> Tuple[float, float]:
    """The FIRST round that attains the maximum validation accuracy reports
    its test accuracy."""
    if not len(val_curve):
        return 0.0, 0.0
    i = int(np.argmax(np.asarray(val_curve)))
    return float(val_curve[i]), float(test_curve[i])


def comm_report(cfg: FederatedConfig, g: Graph, part: Partition):
    """Pre-training communication accounting (Theorem 1 / Appendix F)."""
    if cfg.method != "fedgat":
        return None
    fn = comm_mod.comm_cost_for_engine(cfg.model.engine)
    return fn(g, part, num_layers=cfg.model.num_layers) if fn is not None else None


class Mesh(NamedTuple):
    """What a shard_map run laid its work over: one named axis (``clients``
    over the ranks of the process group, or ``lanes`` of a cohort), with one
    device a rank."""

    axis_name: str
    axis_size: int
    num_processes: int
    device: torch.device


def mesh_description(mesh: Optional[Mesh]) -> Optional[Dict[str, Any]]:
    """Serializable form of a :class:`Mesh` for result dicts, with the
    reference's keys. ``num_devices`` counts the devices the run drives,
    one a rank; ``platform`` is ``"gpu"`` for CUDA, else ``"cpu"``."""
    if mesh is None:
        return None
    return {
        "axis_names": [mesh.axis_name],
        "axis_sizes": [int(mesh.axis_size)],
        "num_devices": int(mesh.num_processes),
        "num_processes": int(mesh.num_processes),
        "platform": "gpu" if mesh.device.type == "cuda" else "cpu",
    }


def build_result(
    *,
    cfg: FederatedConfig,
    params: Any,
    val_curve: List[float],
    test_curve: List[float],
    part: Partition,
    g: Graph,
    seconds: float,
    mesh: Optional[Mesh] = None,
    cohort: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The reference's result schema. ``cohort`` is the cohort driver's
    report when the run was cohort-streamed, else ``None``; ``mesh`` is the
    shard_map run's :class:`Mesh`, described by :func:`mesh_description`."""
    best_val, best_test = best_metrics(val_curve, test_curve)
    node_influence = (
        node_influence_bound(g) if cfg.privacy.dp_granularity == "node" else None
    )
    privacy = privacy_report(
        cfg.privacy, rounds=cfg.rounds, num_clients=cfg.num_clients,
        num_selected=num_selected(cfg), pack_released=pack_released(cfg),
        node_influence=node_influence,
    )
    comm = comm_report(cfg, g, part)
    if telemetry.enabled():
        telemetry.gauge("federated.rounds").set(float(cfg.rounds))
        telemetry.gauge("federated.seconds").set(float(seconds))
        if privacy["epsilon"] is not None:
            telemetry.gauge("privacy.epsilon").set(float(privacy["epsilon"]))
    return {
        "params": _as_parameters(params),
        "val_curve": val_curve,
        "test_curve": test_curve,
        "best_val": best_val,
        "best_test": best_test,
        "final_test": test_curve[-1] if test_curve else 0.0,
        "comm": comm,
        "partition": part,
        "seconds": seconds,
        "backend": cfg.backend,
        "mesh": mesh_description(mesh),
        "cohort": cohort,
        "epsilon": privacy["epsilon"],
        "privacy": privacy,
        "manifest": build_manifest(cfg=cfg, mesh=mesh_description(mesh)),
    }


def _as_parameters(tree: Tree) -> nn.ModuleList:
    return nn.ModuleList([
        nn.ParameterDict({k: nn.Parameter(v) for k, v in layer.items()}) for layer in tree
    ])


# ---------------------------------------------------------------------------
# Run set-up shared by the Trainer's loop and the cohort driver
# ---------------------------------------------------------------------------

class RunSetup(NamedTuple):
    """What a vmap run builds once: the partition, the initial global
    params, the local phase and the evaluation of the global params."""

    part: Partition
    params: Tree
    local_update: Callable
    evaluate: Callable      # params -> (val_acc, test_acc) as floats


def setup_run(cfg: FederatedConfig, g: Graph, dev: torch.device,
              params: Optional[Any], pack: Optional[Any]) -> RunSetup:
    part = dirichlet_partition(g.labels, cfg.num_clients, cfg.beta, cfg.seed)
    init_fn, forward = build_forward(cfg, g, dev, pack)
    if params is None:
        gparams = init_fn(torch.Generator().manual_seed(cfg.seed))
    else:
        gparams = param_tree(params_from_numpy(params, device=dev))
    labels = torch.as_tensor(g.labels, dtype=torch.int64, device=dev)
    val_mask = torch.as_tensor(g.val_mask, device=dev)
    test_mask = torch.as_tensor(g.test_mask, device=dev)
    full_mask = torch.as_tensor(g.nbr_mask, device=dev)

    def evaluate(p):
        with torch.inference_mode():
            logits = forward(p, full_mask)
            return (float(masked_accuracy(logits, labels, val_mask)),
                    float(masked_accuracy(logits, labels, test_mask)))

    return RunSetup(part, gparams, make_local_update(make_loss_fn(forward, labels), cfg),
                    evaluate)


class ClientOptimizers:
    """The Adam states of all K clients on the run's device, each leaf with
    a leading client axis; a client's local phase reads its row and writes
    it back, so unselected clients keep theirs."""

    def __init__(self, template: Tree, num_clients: int):
        dev = tree_leaves(template)[0].device
        K = num_clients
        self.step = torch.zeros(K, dtype=torch.int32, device=dev)
        self.mu = tree_map(lambda p: torch.zeros((K,) + p.shape, dtype=p.dtype, device=dev),
                           template)
        self.nu = tree_map(lambda p: torch.zeros((K,) + p.shape, dtype=p.dtype, device=dev),
                           template)

    def local_phase(self, local_update: Callable, gparams: Tree, c: int,
                    nb_mask: torch.Tensor, tr_mask: torch.Tensor, noise_seed: int) -> Tree:
        """Client ``c``'s local update from ``gparams``; returns its params."""
        opt = AdamState(self.step[c], tree_map(lambda x: x[c], self.mu),
                        tree_map(lambda x: x[c], self.nu))
        p, opt = local_update(gparams, opt, nb_mask, tr_mask, noise_seed)
        self.step[c] = opt.step
        tree_map(lambda full, new: full[c].copy_(new), self.mu, opt.mu)
        tree_map(lambda full, new: full[c].copy_(new), self.nu, opt.nu)
        return p


def record_epsilon(cfg: FederatedConfig, t: int) -> None:
    """Host-side ε trajectory for traced DP runs: the accountant's value
    after round ``t``, as the ``privacy.epsilon`` gauge and an event."""
    priv = cfg.privacy
    if not (telemetry.enabled() and priv.dp_enabled):
        return
    q = num_selected(cfg) / cfg.num_clients
    eps = compute_epsilon(priv.noise_multiplier, t + 1, q, priv.delta)
    telemetry.gauge("privacy.epsilon").set(eps)
    telemetry.event("privacy.round", round=t, epsilon=telemetry.gauge("privacy.epsilon").value)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

class Trainer:
    """Federated trainer on one device (default ``cuda``); backend selected
    by ``cfg.backend``."""

    def __init__(self, cfg: FederatedConfig, *, device: DeviceLike = None):
        # The reference's checks (repro/federated/trainer.py, Trainer.__init__).
        if cfg.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {cfg.backend!r}: supported backends are {list(BACKENDS)}"
            )
        if not 0.0 < cfg.client_fraction <= 1.0:
            raise ValueError(f"client_fraction={cfg.client_fraction} must be in (0, 1]")
        if cfg.aggregation_mode not in AGGREGATION_MODES:
            raise ValueError(
                f"unknown aggregation_mode {cfg.aggregation_mode!r}: "
                f"supported modes are {list(AGGREGATION_MODES)}"
            )
        if cfg.max_concurrent_clients is not None:
            if cfg.max_concurrent_clients < 1:
                raise ValueError(
                    f"max_concurrent_clients={cfg.max_concurrent_clients} must be >= 1"
                )
            if cfg.max_concurrent_clients > cfg.num_clients:
                raise ValueError(
                    f"max_concurrent_clients={cfg.max_concurrent_clients} exceeds "
                    f"num_clients={cfg.num_clients}: a cohort cannot be larger "
                    "than the client population"
                )
        if not 0.0 <= cfg.churn_drop_rate < 1.0 or not 0.0 <= cfg.churn_join_rate < 1.0:
            raise ValueError("churn rates must be in [0, 1)")
        if cfg.churn_drop_rate > 0 or cfg.churn_join_rate > 0:
            if cfg.aggregation_mode != "buffered":
                raise ValueError(
                    "mid-round churn (churn_drop_rate / churn_join_rate) "
                    "requires aggregation_mode='buffered'"
                )
            if cfg.privacy.noise_multiplier > 0:
                raise ValueError(
                    "mid-round churn with DP noise is not supported: the "
                    "noise std and the RDP accountant are calibrated to the "
                    "CS(t) participant count, which churn perturbs — disable "
                    "churn or set noise_multiplier=0"
                )
        cfg.privacy.validate()
        if cfg.privacy.secure_agg_protocol and cfg.churn_join_rate > 0:
            raise ValueError(
                "secure_agg_mode='protocol' runs key agreement over the "
                "round's advertised CS(t) cohort, so clients joining "
                "mid-round (churn_join_rate > 0) have no pairwise keys — "
                "use secure_agg_mode='pairwise' or disable join churn "
                "(drop churn is supported: dropped clients' masks are "
                "recovered from secret shares)"
            )
        if cfg.privacy.pack_noise_multiplier > 0 and not pack_released(cfg):
            raise ValueError(
                f"pack_noise_multiplier > 0 but method {cfg.method!r} with "
                f"engine {method_model_config(cfg).engine!r} never releases "
                "a pack — there is nothing to noise (use a pack-based "
                "engine like 'matrix'/'vector', or drop the knob)"
            )
        if cfg.method not in ("fedgat", "distgat", "fedgcn"):
            raise ValueError(f"unknown federated method {cfg.method!r}")
        self.cfg = cfg
        self.device = resolve_device(device)

    def run(self, g: Graph, params: Optional[Any] = None,
            pack: Optional[Any] = None) -> Dict[str, Any]:
        """Train on ``g``. ``params`` are the initial global params (an
        ``nn.ModuleList`` or the reference's list of dicts of arrays); by
        default they are drawn from ``torch.Generator().manual_seed(seed)``.
        ``pack`` is the pre-communicated pack of a pack engine (the port's,
        or the reference's as numpy arrays); by default it is precomputed
        under :func:`pack_generator`. Torch cannot reproduce ``jax.random``
        bits, so passing the reference's own initial params (and pack) is
        the only way to hold the two packages' trajectories against each
        other."""
        if self.cfg.backend == "shard_map":
            from repro_torch.federated.sharded import _run_shard_map  # lazy: avoid cycle

            return _run_shard_map(g, self.cfg, device=self.device, params=params, pack=pack)
        if cohort_active(self.cfg):
            # Cohort streaming: the same schedule and privacy streams, with
            # lanes bounded by max_concurrent_clients instead of n_sel.
            return run_cohort_rounds(g, self.cfg, backend="vmap", device=self.device,
                                     params=params, pack=pack)
        return self._run_vmap(g, params, pack)

    def _run_vmap(self, g: Graph, params: Optional[Any], pack: Optional[Any]) -> Dict[str, Any]:
        cfg, dev = self.cfg, self.device
        run = setup_run(cfg, g, dev, params, pack)
        nb_masks, tr_masks = client_masks(cfg, g, run.part, dev)
        bank = ClientOptimizers(run.params, cfg.num_clients)
        server_state = adam_init(run.params)
        priv = cfg.privacy
        noise_base, mask_base = noise_base_key(cfg.seed), mask_base_key(cfg.seed)
        sel_sched, chosen_sched = selection_schedule(cfg)

        def round_step(gparams, server_state, t):
            client_params = []
            for c in chosen_sched[t].tolist():
                p = bank.local_phase(run.local_update, gparams, c, nb_masks[c].contiguous(),
                                     tr_masks[c], client_round_key(noise_base, t, c))
                if priv.secure_agg:
                    # Each selected client ships a masked update; the
                    # pairwise masks cancel in the mean below.
                    p = add_client_mask(mask_base, t, c, sel_sched[t], p, priv.mask_scale)
                client_params.append(p)
            stacked = tree_map(lambda *ps: torch.stack(ps), *client_params)
            if cfg.aggregator == "fedadam":
                return fedadam_server(gparams, stacked, server_state, cfg.server_lr)
            return fedavg(stacked), server_state

        gparams = run.params
        val_curve: List[float] = []
        test_curve: List[float] = []
        t0 = time.time()
        for t in range(cfg.rounds):
            with telemetry.span("round", round=t, backend="vmap"):
                with telemetry.span("step", selected=int(sel_sched[t].sum())):
                    gparams, server_state = round_step(gparams, server_state, t)
                with telemetry.span("evaluate"):
                    va, ta = run.evaluate(gparams)
            val_curve.append(va)
            test_curve.append(ta)
            record_epsilon(cfg, t)

        return build_result(
            cfg=cfg, params=gparams, val_curve=val_curve,
            test_curve=test_curve, part=run.part, g=g, seconds=time.time() - t0,
        )


def run_federated(
    g: Graph,
    cfg: FederatedConfig,
    *,
    backend: Optional[str] = None,
    device: DeviceLike = None,
    params: Optional[Any] = None,
    pack: Optional[Any] = None,
) -> Dict[str, Any]:
    """Run federated training; ``backend`` overrides ``cfg.backend``,
    ``params`` are the initial params and ``pack`` the pre-communicated
    pack (see :meth:`Trainer.run`)."""
    if backend is not None:
        cfg = replace(cfg, backend=backend)
    return Trainer(cfg, device=device).run(g, params=params, pack=pack)


# ---------------------------------------------------------------------------
# Centralised baselines
# ---------------------------------------------------------------------------

def train_centralized(
    g: Graph,
    model: str = "gat",
    steps: int = 200,
    lr: float = 0.01,
    weight_decay: float = 1e-3,
    seed: int = 0,
    mcfg: Optional[FedGATConfig] = None,
    gcn_hidden: int = 16,
    *,
    device: DeviceLike = None,
    params: Optional[Any] = None,
    pack: Optional[Any] = None,
) -> Dict[str, Any]:
    """Centralised GAT / GCN / FedGAT-approximation baselines (Table 1).
    ``params`` are the initial params and ``pack`` the pack of a pack
    engine, as for :meth:`Trainer.run`."""
    dev = resolve_device(device)
    labels = torch.as_tensor(g.labels, dtype=torch.int64, device=dev)
    gen = torch.Generator().manual_seed(seed)
    if model == "gcn":
        h, nbr_idx, _ = graph_tensors(g, dev)
        coef = torch.as_tensor(normalized_nbr_coeffs(g.nbr_idx, g.nbr_mask), device=dev)
        init = init_gcn_params(gen, g.feature_dim, gcn_hidden, g.num_classes, device=dev)

        def forward(p):
            return gcn_forward_nbr(p, h, nbr_idx, coef)
    else:
        mcfg = mcfg or FedGATConfig(engine="exact" if model == "gat" else "direct")
        net = FedGAT(mcfg, device=dev)
        if pack is not None:
            net.install_pack(pack, g)
        else:
            net.precommunicate(pack_generator(seed, net.device), g)
        init = param_tree(net.init(gen, g))

        def forward(p):
            return net.apply(p, g)

    params = init if params is None else param_tree(params_from_numpy(params, device=dev))
    train_mask = torch.as_tensor(g.train_mask, device=dev)
    val_mask = torch.as_tensor(g.val_mask, device=dev)
    test_mask = torch.as_tensor(g.test_mask, device=dev)

    def loss_fn(p):
        return masked_cross_entropy(forward(p), labels, train_mask)

    opt = adam_init(params)
    val_curve, test_curve = [], []
    for _ in range(steps):
        params, opt = adam_update(grad_of(loss_fn, params), opt, params, lr,
                                  weight_decay=weight_decay)
        with torch.inference_mode():
            logits = forward(params)
            val_curve.append(float(masked_accuracy(logits, labels, val_mask)))
            test_curve.append(float(masked_accuracy(logits, labels, test_mask)))
    best_val, best_test = best_metrics(val_curve, test_curve)
    return {
        "params": _as_parameters(params),
        "best_val": best_val,
        "best_test": best_test,
        "final_test": test_curve[-1],
        "val_curve": val_curve,
        "test_curve": test_curve,
    }
