"""Multi-process launcher for the shard_map federated backend.

The port of ``repro/launch/multiprocess.py``. ``federated/sharded.py`` lays
the clients over the ranks of a ``torch.distributed`` process group (one
process a party, the deployment shape of cross-silo federated learning);
this module stands those processes up.

Two halves, one env-var protocol:

* **Launcher** (:func:`launch`): spawns N copies of a worker command on
  this host, each with ``REPRO_MP_*`` env vars carrying the coordinator
  address, process id/count, the clients a process may host and the
  rendezvous timeout. It babysits the workers: the first non-zero exit
  reaps every sibling and becomes the launcher's own exit code; a
  wall-clock timeout bounds hangs (exit 124); an explicitly requested
  coordinator port that is already bound is an immediate error, not a
  stuck rendezvous.

* **Worker bootstrap** (:func:`initialize_worker`): reads the protocol
  env vars and joins the process group through a TCP store at the
  coordinator address (rank 0 serves it). The join is bounded by the
  launcher's ``init_timeout``; every later collective by the launcher's
  wall-clock ``timeout``, which reaps the gang (the group keeps torch's
  default timeout, ``torch.distributed.constants.default_pg_timeout``,
  so a rank waiting on rank 0's evaluation is not cut at the join's
  bound). A process without the env vars is a
  no-op single-process run, so entry points can call it unconditionally.

A torch process drives one device: ``cuda:(rank % device_count)``, or the
CPU when the caller asks for it. The collectives follow one fixed rule,
stated here and printed by the worker:

* ``gloo`` on the CPU (the reference's choice for its CPU processes);
* ``nccl`` on CUDA when every rank has a card of its own
  (``processes <= torch.cuda.device_count()``);
* ``gloo`` over the card's tensors on CUDA when ranks share a card: NCCL
  refuses two ranks on one device, so this is how two parties run on a
  one-card host.

It is not a fallback: nothing is retried and nothing moves to the CPU.
The reference's ``force_host_device_count`` (XLA's flag for simulated
host devices) has no counterpart here, and ``--devices-per-process`` is
the number of clients a process may host.

CLI::

    python -m repro_torch.launch.multiprocess \\
        --processes 2 --devices-per-process 2 --clients 4 --device cpu

trains the federated clients through the shard_map backend; process 0
prints ``RESULT {json}`` and writes ``--out``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

ENV_COORDINATOR = "REPRO_MP_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_MP_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_MP_PROCESS_ID"
ENV_DEVICES = "REPRO_MP_DEVICES_PER_PROCESS"
ENV_INIT_TIMEOUT = "REPRO_MP_INIT_TIMEOUT"

_PROTOCOL_VARS = (
    ENV_COORDINATOR, ENV_NUM_PROCESSES, ENV_PROCESS_ID, ENV_DEVICES,
    ENV_INIT_TIMEOUT,
)


def worker_env_active(env: Optional[Dict[str, str]] = None) -> bool:
    """True when this process was spawned by :func:`launch`."""
    return ENV_COORDINATOR in (os.environ if env is None else env)


def collectives_for(device, num_processes: int) -> str:
    """The collectives backend of the fixed rule (module docstring)."""
    import torch

    if torch.device(device).type == "cpu":
        return "gloo"
    return "nccl" if num_processes <= torch.cuda.device_count() else "gloo"


def initialize_worker(
    env: Optional[Dict[str, str]] = None, device=None,
) -> Tuple[int, int, Optional[str]]:
    """Worker-side bootstrap; returns ``(process_id, num_processes,
    collectives)``.

    No-op ``(0, 1, None)`` when the launcher protocol is absent. Otherwise,
    with more than one process: sets the rank's CUDA device
    (``rank % device_count``) unless ``device`` is the CPU, picks the
    collectives by :func:`collectives_for` and joins the process group.
    ``device`` defaults to ``cuda``.
    """
    e = os.environ if env is None else env
    if not worker_env_active(e):
        return 0, 1, None
    process_id = int(e[ENV_PROCESS_ID])
    num_processes = int(e[ENV_NUM_PROCESSES])
    if num_processes <= 1:
        return process_id, num_processes, None
    import torch
    import torch.distributed as dist

    from repro_torch._device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    collectives = collectives_for(dev, num_processes)
    host, port = e[ENV_COORDINATOR].rsplit(":", 1)
    # The store is the rendezvous: its timeout bounds the join alone. Given
    # to init_process_group, the same timeout would bound every later
    # collective too.
    store = dist.TCPStore(
        host, int(port), num_processes, is_master=process_id == 0,
        timeout=datetime.timedelta(seconds=float(e.get(ENV_INIT_TIMEOUT, "60"))),
    )
    dist.init_process_group(collectives, store=store, rank=process_id,
                            world_size=num_processes)
    return process_id, num_processes, collectives


def free_coordinator_port() -> int:
    """An OS-assigned free TCP port for the coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _check_port_free(port: int) -> None:
    try:
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", port))
    except OSError as err:
        raise RuntimeError(
            f"coordinator port {port} is already in use ({err}); pick a "
            "free port or omit --coordinator-port to auto-assign one"
        ) from None


def _reap(procs: Sequence[subprocess.Popen], grace: float = 5.0) -> None:
    """Terminate every still-running worker (SIGTERM, then SIGKILL)."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def launch(
    cmd: Sequence[str],
    *,
    processes: int,
    devices_per_process: int,
    coordinator_port: Optional[int] = None,
    timeout: float = 900.0,
    init_timeout: float = 60.0,
    env: Optional[Dict[str, str]] = None,
) -> int:
    """Run ``cmd`` as ``processes`` cooperating workers; return an exit code.

    Each worker inherits this environment plus the ``REPRO_MP_*`` protocol
    vars (:func:`initialize_worker` consumes them). Failure semantics:

    * any worker exiting non-zero reaps every sibling and its code is
      returned (the death of one participant deadlocks the rest at their
      next collective — they must not linger);
    * ``timeout`` seconds without completion reaps everything and returns
      124 (the ``timeout(1)`` convention);
    * an explicitly requested ``coordinator_port`` that is already bound
      raises ``RuntimeError`` before anything is spawned.
    """
    if processes < 1:
        raise ValueError(f"processes must be >= 1, got {processes}")
    if devices_per_process < 1:
        raise ValueError(
            f"devices_per_process must be >= 1, got {devices_per_process}"
        )
    if coordinator_port is None:
        coordinator_port = free_coordinator_port()
    else:
        _check_port_free(coordinator_port)

    base = dict(os.environ if env is None else env)
    for var in _PROTOCOL_VARS:   # never inherit a stale protocol
        base.pop(var, None)

    procs: List[subprocess.Popen] = []
    try:
        for i in range(processes):
            wenv = dict(base)
            wenv[ENV_COORDINATOR] = f"127.0.0.1:{coordinator_port}"
            wenv[ENV_NUM_PROCESSES] = str(processes)
            wenv[ENV_PROCESS_ID] = str(i)
            wenv[ENV_DEVICES] = str(devices_per_process)
            wenv[ENV_INIT_TIMEOUT] = str(init_timeout)
            procs.append(subprocess.Popen(list(cmd), env=wenv))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                _reap(procs)
                print(
                    f"[multiprocess] worker died with exit code {bad[0]}; "
                    "reaped remaining workers",
                    file=sys.stderr, flush=True,
                )
                return int(bad[0])
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() > deadline:
                _reap(procs)
                print(
                    f"[multiprocess] timed out after {timeout:.0f}s; "
                    "reaped all workers",
                    file=sys.stderr, flush=True,
                )
                return 124
            time.sleep(0.1)
    finally:
        _reap(procs)


def launch_self(
    argv: Sequence[str],
    *,
    processes: int,
    devices_per_process: int,
    coordinator_port: Optional[int] = None,
    timeout: float = 900.0,
) -> int:
    """Re-run ``sys.executable argv`` as N workers (argv[0] is the script).

    Used by entry points that are their own worker: the re-exec carries the
    same argv, and the child detects worker mode via the protocol env vars.
    """
    return launch(
        [sys.executable, *argv],
        processes=processes,
        devices_per_process=devices_per_process,
        coordinator_port=coordinator_port,
        timeout=timeout,
    )


# ---------------------------------------------------------------------------
# CLI: federated training over the process group
# ---------------------------------------------------------------------------

def _parse(argv: Optional[Sequence[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.multiprocess",
        description="train the federated shard_map backend over a "
        "multi-process group (cross-silo deployment on one host)",
    )
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--devices-per-process", type=int, default=2,
                    help="clients a process may host (a process drives one device)")
    ap.add_argument("--coordinator-port", type=int, default=None,
                    help="coordinator TCP port (default: auto-assign)")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="launcher wall-clock bound in seconds")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--aggregator", default="fedavg",
                    choices=["fedavg", "fedprox", "fedadam"])
    ap.add_argument("--client-fraction", type=float, default=1.0)
    ap.add_argument("--method", default="fedgat",
                    choices=["fedgat", "distgat", "fedgcn"])
    ap.add_argument("--engine", default="direct",
                    help="layer-1 engine for fedgat (registry name)")
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--dataset", default="tiny")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--noise-multiplier", type=float, default=0.0)
    ap.add_argument("--clip", type=float, default=float("inf"))
    ap.add_argument("--secure-agg", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None,
                    help="process 0 writes the result summary JSON here")
    return ap.parse_args(argv)


def result_summary(res: Dict, num_processes: int) -> Dict:
    """The JSON-serialisable slice of a Trainer result (params dropped)."""
    return {
        "backend": res["backend"],
        "num_processes": num_processes,
        "mesh": res["mesh"],
        "val_curve": res["val_curve"],
        "test_curve": res["test_curve"],
        "best_val": res["best_val"],
        "best_test": res["best_test"],
        "final_test": res["final_test"],
        "epsilon": res["epsilon"],
        "seconds": res["seconds"],
    }


def _worker_main(args: argparse.Namespace) -> int:
    process_id, num_processes, collectives = initialize_worker(device=args.device)
    import torch.distributed as dist

    from repro_torch._device import resolve_device
    from repro_torch.core.fedgat_model import FedGATConfig
    from repro_torch.federated.trainer import FederatedConfig, run_federated
    from repro_torch.graphs import make_cora_like
    from repro_torch.privacy import PrivacyConfig

    try:
        dev = resolve_device(args.device)
        print(f"[multiprocess] rank {process_id}/{num_processes} device {dev} "
              f"collectives {collectives}", flush=True)
        g = make_cora_like(args.dataset, args.seed)
        cfg = FederatedConfig(
            method=args.method,
            backend="shard_map",
            num_clients=args.clients,
            rounds=args.rounds,
            local_steps=args.local_steps,
            aggregator=args.aggregator,
            client_fraction=args.client_fraction,
            seed=args.seed,
            model=FedGATConfig(engine=args.engine, degree=args.degree),
            privacy=PrivacyConfig(
                noise_multiplier=args.noise_multiplier,
                clip=args.clip,
                secure_agg=args.secure_agg,
                # The field-masking protocol needs the host-side cohort
                # driver, which is single-process; across processes the
                # pairwise masks (cancelling in the all_reduce) are the
                # supported mode.
                secure_agg_mode="pairwise",
            ),
        )
        res = run_federated(g, cfg, device=dev)
        if process_id == 0:
            summary = result_summary(res, num_processes)
            print("RESULT " + json.dumps(summary), flush=True)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(summary, f, indent=1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parse(argv)
    if worker_env_active():
        return _worker_main(args)
    if args.processes * args.devices_per_process < args.clients:
        raise SystemExit(
            f"{args.clients} clients need >= {args.clients} devices but "
            f"--processes {args.processes} x --devices-per-process "
            f"{args.devices_per_process} provides only "
            f"{args.processes * args.devices_per_process}"
        )
    return launch_self(
        ["-m", "repro_torch.launch.multiprocess", *(argv or sys.argv[1:])],
        processes=args.processes,
        devices_per_process=args.devices_per_process,
        coordinator_port=args.coordinator_port,
        timeout=args.timeout,
    )


if __name__ == "__main__":
    raise SystemExit(main())
