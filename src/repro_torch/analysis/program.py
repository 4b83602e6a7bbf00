"""The per-device program cost of a sharded step (the port's counterpart of
``repro/analysis/hlo_graph.py``).

The reference reads the cost of one device's program from XLA's compiled
SPMD module. The port's per-device program is one rank's eager step, so
:func:`trace_step` runs it: rank ``rank``'s blocks of every argument, as
meta tensors (a shape and a dtype, no data, no allocation), go through the
step on a :class:`~repro_torch.launch.mesh.TracedMesh`, under a
``TorchDispatchMode`` that sees every aten op of the forward and the
backward and counts, per device:

  * dot flops        -- 2 * prod(out) * prod(contracting dims), the
                        reference's rule (``torch.utils.flop_counter``'s
                        formulas for mm, addmm, bmm, baddbmm and convolution)
  * traffic bytes    -- each op's input and output bytes, as XLA's
                        ``bytes accessed``; views and aliases (the analogue
                        of ``_SKIP_BYTES_KINDS``) and bare allocations move
                        nothing
  * transcendentals  -- the output elements of ops that evaluate exp, log,
                        tanh, sigmoid, erf, a square root, a softmax, ...
  * collective bytes -- by kind, from the traced mesh's counts: what
                        ``BoundMesh.traffic`` reads after a real call
  * peak temp bytes  -- the most bytes live at once in tensors that are
                        neither arguments nor outputs

The stand-ins of a collective count as traffic as they run: an all_reduce's
clone (its operand and result, as XLA counts an all-reduce), an
all_gather's empty parts and their concatenation.

Loops over time (``models.layers.time_scan``: RWKV's wkv, Mamba's selective
scan) run one step for all of them, as ``hlo_graph`` scales a while body by
its trip count: the step's forward and its vjp are counted once and weighed
by the trip count, the outputs are the first step's broadcast over time,
and the step's saved tensors count once per step towards the peak. The
``*_unscaled`` counts take every loop body once (XLA's own
``cost_analysis``). ``scale_loops=False`` unrolls the loops instead (the
same counts, far slower).

The listing has one line per op with its result, ``%n = bf16[16,4096]
mm(bf16[16,4096], bf16[4096,4096])``; a collective is written as HLO writes
it (``all-reduce(`` / ``all-gather(``, which ``analysis.hlo.
parse_collectives`` reads), and a loop body appears once inside ``while
trip_count=N { ... }``.
"""
from __future__ import annotations

import contextlib
import itertools
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch._tree import tree_leaves
from repro_torch.launch.mesh import trace_mesh
from repro_torch.launch.sharding import map_tree
from repro_torch.models.layers import scan_tracer

aten = torch.ops.aten

HLO_DTYPE = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.int32: "s32", torch.float32: "f32",
    torch.int64: "s64", torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128",
}
KIND = {"all_reduce": "all-reduce", "all_gather": "all-gather"}   # the mesh's names -> HLO's

# allocations that read and write nothing
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
               aten.new_empty_strided}
# one transcendental function per output element (two for logaddexp)
_TRANSCENDENTAL = {
    aten.exp: 1, aten.exp2: 1, aten.expm1: 1, aten.log: 1, aten.log2: 1, aten.log10: 1,
    aten.log1p: 1, aten.tanh: 1, aten.sigmoid: 1, aten.rsqrt: 1, aten.sqrt: 1, aten.sin: 1,
    aten.cos: 1, aten.tan: 1, aten.atan2: 1, aten.erf: 1, aten.erfc: 1, aten.erfinv: 1,
    aten.silu: 1, aten.silu_backward: 1, aten.gelu: 1, aten.gelu_backward: 1,
    aten.softplus: 1, aten.softplus_backward: 1, aten._softmax: 1, aten._log_softmax: 1,
    aten._log_softmax_backward_data: 1, aten.logaddexp: 2, aten.log_sigmoid_forward: 2,
}


def _shape(t: torch.Tensor) -> str:
    return f"{HLO_DTYPE.get(t.dtype, str(t.dtype))}[{','.join(map(str, t.shape))}]"


def _tensors(xs) -> List[torch.Tensor]:
    """The tensors among ``xs`` and in its lists and tuples (an aten op's
    arguments and results nest no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class ProgramCost:
    """Per-device totals of one traced step (``HLOCost``'s fields)."""
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_kind: Dict[str, float] = field(default_factory=dict)
    collective_calls_by_kind: Dict[str, int] = field(default_factory=dict)
    transcendentals: float = 0.0
    flops_unscaled: float = 0.0          # each loop body once (XLA's view)
    traffic_bytes_unscaled: float = 0.0
    transcendentals_unscaled: float = 0.0

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "traffic_bytes": self.traffic_bytes,
            "collective_bytes": self.collective_bytes,
            "collective_by_kind": dict(self.collective_by_kind),
            "flops_unscaled": self.flops_unscaled,
            "transcendentals": self.transcendentals,
            "collective_calls_by_kind": dict(self.collective_calls_by_kind),
        }


class _Mode(TorchDispatchMode):
    def __init__(self, tracer: "_Tracer"):
        super().__init__()
        self.tracer = tracer

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.tracer.op(func, args, kwargs, out)
        return out


class _Tracer:
    """The counts, the listing and the live bytes of one traced step."""

    def __init__(self):
        self.cost = ProgramCost()
        self.lines: List[str] = []
        self.trips: List[int] = []        # enclosing loops' trip counts
        self.mult = 1
        self.quiet = 0                    # > 0: ops run uncounted (a step run again)
        self._ids = itertools.count()
        self._n = itertools.count()       # listing value numbers
        self.live: Dict[int, Tuple[Any, int, int]] = {}   # storage -> (weakref, bytes, id)
        self.live_bytes = 0
        self.events: List[Tuple[int, int]] = []           # (allocation id, +/- bytes)
        self.closed = False

    # -- the listing and the counts ---------------------------------------

    def emit(self, text: str) -> None:
        self.lines.append("  " * (1 + len(self.trips)) + text)

    def op(self, func, args, kwargs, out) -> None:
        outs = _tensors((out,))
        if self.quiet:                     # a replay: its tensors live, it costs nothing
            if not func.is_view:
                for o in outs:
                    self.track(o)
            return
        ins = _tensors(args) + _tensors(kwargs.values())
        packet, m, c = func.overloadpacket, self.mult, self.cost
        alias = func.is_view or (not func._schema.is_mutable and outs
                                 and not any([self.track(o) for o in outs]))
        if not alias and packet not in _NO_TRAFFIC:
            b = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
            c.traffic_bytes += m * b
            c.traffic_bytes_unscaled += b
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += m * f
            c.flops_unscaled += f
        k = _TRANSCENDENTAL.get(packet)
        if k is None and packet is aten.pow and not (
                len(args) > 1 and isinstance(args[1], (int, float)) and float(args[1]).is_integer()):
            k = 1                          # x ** y but for an integer power
        if k and outs:
            n = k * outs[0].numel()
            c.transcendentals += m * n
            c.transcendentals_unscaled += n
        res = ", ".join(map(_shape, outs))
        self.emit(f"%{next(self._n)} = {res if len(outs) == 1 else f'({res})'} "
                  f"{packet.__name__}({', '.join(map(_shape, ins))})")

    def collective(self, kind: str, operand, result, members) -> None:
        self.emit(f"%{next(self._n)} = {_shape(result)} {KIND[kind]}({_shape(operand)}), "
                  f"replica_groups={{{','.join(map(str, members))}}}")

    @contextlib.contextmanager
    def loop(self, trips: int):
        """Within: ops count ``trips`` times (a loop body, once)."""
        self.emit(f"while trip_count={trips} {{")
        self.trips.append(trips)
        self.mult *= trips
        try:
            yield
        finally:
            self.trips.pop()
            self.mult //= trips
            self.emit("}")

    # -- live bytes -------------------------------------------------------

    def known(self, t: torch.Tensor) -> None:
        """Note ``t``'s storage as held outside the step (an argument)."""
        self.live[t.untyped_storage()._cdata] = (None, 0, -1)

    def track(self, t: torch.Tensor) -> bool:
        """Note ``t``'s storage if it is new (an allocation); True if it was."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return False
        ident, nbytes = next(self._ids), st.nbytes()
        self.live[key] = (weakref.ref(st, lambda _, key=key: self._freed(key)), nbytes, ident)
        self._add(ident, nbytes)
        return True

    def _freed(self, key: int) -> None:
        if not self.closed:
            _, nbytes, ident = self.live.pop(key)
            self._add(ident, -nbytes)

    def _add(self, ident: int, nbytes: int) -> None:
        self.live_bytes += nbytes
        self.events.append((ident, nbytes))

    def hold(self, nbytes: int):
        """Count ``nbytes`` as live until the returned release is first
        called."""
        ident, held = next(self._ids), [nbytes]
        self._add(ident, nbytes)

        def release():
            if held and not self.closed:
                self._add(ident, -held.pop())
        return release

    def peak_without(self, tensors) -> int:
        """The most bytes live at once, less the storages of ``tensors``."""
        skip = {self.live[t.untyped_storage()._cdata][2] for t in tensors
                if t.untyped_storage()._cdata in self.live}
        cur = peak = 0
        for ident, nbytes in self.events:
            if ident not in skip:
                cur += nbytes
                peak = max(peak, cur)
        return peak

    # -- loops over time ----------------------------------------------------

    def scan(self, step, carry, xs, consts):
        """``layers.time_scan`` under the trace: one step for all of them."""
        return _Scan.apply(self, step, len(xs), carry, *xs, *consts)


class _Scan(torch.autograd.Function):
    """One step of a time loop, counted for every step: the forward under
    the loop's trip count, and in the backward the step's vjp under the
    same count (the step is run again, uncounted, to take it). Values are
    the first step's, broadcast over time."""

    @staticmethod
    def forward(ctx, tracer, step, n_x, carry, *tensors):
        ctx.set_materialize_grads(False)
        xs = tensors[:n_x]
        trips = xs[0].shape[1]
        grad = any(ctx.needs_input_grad[3:])
        before = tracer.live_bytes
        with torch.set_grad_enabled(grad), tracer.loop(trips):
            new_carry, y = _one_step(step, n_x, carry, tensors, grad)
        ctx.tracer, ctx.step, ctx.trips, ctx.n_x = tracer, step, trips, n_x
        if grad:
            ctx.save_for_backward(carry, *tensors)
            # what one step keeps for its backward (less its outputs: the next
            # step's carry, a row of ys), kept by every step
            kept = tracer.live_bytes - before - _nbytes(new_carry) - _nbytes(y)
            ctx.release = tracer.hold((trips - 1) * max(kept, 0))
            weakref.finalize(ctx, ctx.release)
        ys = y.detach().unsqueeze(1).expand(y.shape[:1] + (trips,) + y.shape[1:]).contiguous()
        return new_carry.detach(), ys

    @staticmethod
    def backward(ctx, g_carry, g_ys):
        tracer, trips, n_x = ctx.tracer, ctx.trips, ctx.n_x
        carry, *tensors = ctx.saved_tensors
        with torch.enable_grad():
            tracer.quiet += 1
            try:
                ins, outs = _one_step(ctx.step, n_x, carry, tensors, True, keep_inputs=True)
                if g_carry is None:     # a middle step's carry has the next step's cotangent
                    g_carry = torch.zeros_like(outs[0])
            finally:
                tracer.quiet -= 1
        pairs = [(o, g) for o, g in zip(outs, (g_carry, None if g_ys is None else g_ys[:, 0]))
                 if g is not None]
        want = [t for t in ins if t.requires_grad]
        with tracer.loop(trips):
            got = iter(torch.autograd.grad([o for o, _ in pairs], want, [g for _, g in pairs],
                                           allow_unused=True))
        grads = [next(got) if t.requires_grad else None for t in ins]
        ctx.release()
        for i, x in enumerate(tensors[:n_x], start=1):      # a step's grad on every step
            if grads[i] is not None:
                grads[i] = grads[i].unsqueeze(1).expand(x.shape).contiguous()
        return (None, None, None, *grads)


def _one_step(step, n_x, carry, tensors, grad: bool, keep_inputs: bool = False):
    """``step`` on the first step's slices; with ``grad``, on leaves that
    require grad (the carry too: after the first step it depends on the
    inputs)."""
    ins = [carry] + [x[:, 0] for x in tensors[:n_x]] + list(tensors[n_x:])
    if grad:
        ins = [t.detach().requires_grad_(t.is_floating_point()) for t in ins]
    outs = step(ins[0], *ins[1:1 + n_x], *ins[1 + n_x:])
    return (ins, outs) if keep_inputs else outs


def block_specs(args, in_shardings, view) -> Any:
    """Meta tensors of ``view``'s blocks of ``args`` (meta specs) under their
    placements."""
    def block(x, sh):
        shape = [b - a for a, b in view.bounds(sh.spec, x.shape)]
        return torch.empty(shape, dtype=x.dtype, device="meta")

    return map_tree(block, args, in_shardings)


def trace_step(fn, args, in_shardings, mesh, rank: int = 0, *,
               scale_loops: bool = True) -> Tuple[ProgramCost, str, int]:
    """Trace rank ``rank``'s program of ``fn``, a step from
    ``launch.steps.build_sharded_step`` on ``mesh``, with the meta
    ``args`` and the ``in_shardings`` it returned. Returns ``(cost,
    listing, peak_temp_bytes)`` (see the module docstring). Runs on the
    host and allocates nothing of the step's tensors."""
    view = trace_mesh(mesh, rank)
    blocks = block_specs(args, in_shardings, view)
    tracer = _Tracer()
    for t in tree_leaves(blocks):
        if isinstance(t, torch.Tensor):
            tracer.known(t)
    view.on_collective = tracer.collective
    step = fn.on(view)
    scans = scan_tracer(tracer) if scale_loops else contextlib.nullcontext()
    try:
        with scans, _Mode(tracer):
            out = step(*blocks)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        peak = tracer.peak_without(outs)
    finally:
        tracer.closed = True
    c = tracer.cost
    for kind, t in view.traffic.items():
        if t["calls"]:
            c.collective_by_kind[KIND[kind]] = float(t["bytes"])
            c.collective_calls_by_kind[KIND[kind]] = t["calls"]
    c.collective_bytes = sum(c.collective_by_kind.values())
    header = (f"program rank={rank} mesh=" + ",".join(
        f"{a}:{n}" for a, n in view.shape.items()) + "\n")
    return c, header + "\n".join(tracer.lines) + "\n", peak
