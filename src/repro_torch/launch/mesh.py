"""Meshes (the port of ``repro/launch/mesh.py``) and their binding to the
ranks of a ``torch.distributed`` group.

A :class:`Mesh` is a plain description: axis names and sizes, with the
device ids laid out row-major in ``devices`` (ranks, on a bound mesh). It
touches no device, so the production meshes (16x16 and 2x16x16) can be
described on any host, as the dry-run does.

:func:`bind_mesh` lays a mesh over the live process group: rank r sits at
the row-major coordinates of r, and holds of every sharded tensor the
block that JAX's ``NamedSharding`` gives the device at those coordinates.
A :class:`BoundMesh` makes one ``dist.new_group`` for every set of ranks
that differ only along some subset of the axes, so a collective can run
over any axis or joint axis tuple. Its collectives are ``all_reduce`` and
``all_gather``, the two that gloo runs over CUDA tensors of ranks sharing
one card as well as on the CPU (``tools/gloo_cuda_probe.py``).
:func:`trace_mesh` gives one rank's view with no process group (a
:class:`TracedMesh`), on which a sharded step runs over meta tensors for
the dry-run's program cost. Both share every line of :class:`RankView`
but the two seams through which a collective reaches the other ranks.

Autograd across ranks follows the reference's ``shard_map`` (with
``check_vma=False``): :meth:`RankView.psum` sums partial values into a
replicated one and passes the replicated cotangent through to each
partial; :meth:`RankView.pbroadcast` marks a replicated value that the
ranks go on to use differently, and sums their cotangents;
:meth:`RankView.pgather` gathers the ranks' blocks of a value whole for a
use that differs by rank, and hands each rank the sum of the cotangents of
its block. A replicated value's cotangent is then the true one on every
rank.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes (the fields of a ``jax.sharding.Mesh``
    that the sharding rules read)."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def devices(self) -> np.ndarray:
        """Device ids (ranks, once bound) laid out row-major on the mesh."""
        return np.arange(int(np.prod(self.axis_sizes))).reshape(self.axis_sizes)

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def data_axes(mesh) -> tuple:
    """The batch-parallel axes of a production mesh."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_debug_mesh(data: int = 2, model: int = 2) -> Mesh:
    """Small mesh for tests and the smoke run."""
    return Mesh(("data", "model"), (data, model))


# ---------------------------------------------------------------------------
# A mesh over the ranks of a process group
# ---------------------------------------------------------------------------

def spec_axes(spec, ndim: int) -> List[Tuple[str, ...]]:
    """A PartitionSpec as one tuple of mesh axes per dim (``()`` for a
    replicated dim), padded to ``ndim``."""
    out = []
    for entry in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(() if entry is None else (entry,) if isinstance(entry, str) else tuple(entry))
    return out


class RankView:
    """Rank ``rank``'s view of a :class:`Mesh`: its coordinates, its blocks
    of sharded tensors and the mesh's collectives, counted in ``traffic``.
    The collectives reach the other ranks through two seams,
    :meth:`_all_gather` and :meth:`_all_reduce`, which :class:`BoundMesh`
    runs over a process group and :class:`TracedMesh` only describes."""

    def __init__(self, mesh: Mesh, rank: int):
        if not 0 <= rank < mesh.size:
            raise ValueError(f"rank {rank} is not on a {mesh.axis_sizes} mesh")
        self.mesh = mesh
        self.axis_names = mesh.axis_names
        self.shape = mesh.shape
        self.devices = mesh.devices
        self.rank = rank
        self.coords = self.coords_of(rank)
        # per collective: calls and the bytes of their results on this rank
        # (an all_reduce's operand, an all_gather's gathered block)
        self.traffic = {"all_reduce": {"calls": 0, "bytes": 0},
                        "all_gather": {"calls": 0, "bytes": 0}}

    def coords_of(self, rank: int) -> Dict[str, int]:
        idx = np.unravel_index(rank, self.mesh.axis_sizes)
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def axis_size(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes: Sequence[str], coords: Dict[str, int] = None) -> int:
        """The linear index of ``coords`` (default: this rank's) over
        ``axes``, the first axis major (JAX's order for a joint axis)."""
        c = self.coords if coords is None else coords
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def members(self, axes: Sequence[str]) -> List[int]:
        """The ranks that share this rank's coordinates off ``axes``, in
        increasing order (the order of a collective's parts)."""
        idx = tuple(slice(None) if a in axes else self.coords[a] for a in self.axis_names)
        return sorted(int(r) for r in self.devices[idx].reshape(-1))

    # -- blocks of sharded tensors ------------------------------------------

    def bounds(self, spec, shape) -> List[Tuple[int, int]]:
        """This rank's [start, stop) along each dim under ``spec``."""
        out = []
        for n, axes in zip(shape, spec_axes(spec, len(shape))):
            k = self.axis_size(axes)
            if n % k:
                raise ValueError(f"dim {n} does not divide over {axes} ({k})")
            step = n // k
            i = self.index(axes)
            out.append((i * step, (i + 1) * step))
        return out

    def shard(self, full: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of ``full`` under ``spec``."""
        return full[tuple(slice(a, b) for a, b in self.bounds(spec, full.shape))]

    def block(self, x: torch.Tensor, spec_from, spec_to, full_shape) -> torch.Tensor:
        """This rank's block under ``spec_to`` cut from ``x``, its block
        under ``spec_from``; the first must lie inside the second."""
        outer, inner = self.bounds(spec_from, full_shape), self.bounds(spec_to, full_shape)
        idx = []
        for (a, b), (c, d) in zip(outer, inner):
            if c < a or d > b:
                raise ValueError(f"{spec_to} is not inside {spec_from}")
            idx.append(slice(c - a, d - a))
        return x[tuple(idx)]

    def gather(self, x: torch.Tensor, spec, axes: Sequence[str] = None) -> torch.Tensor:
        """All-gather ``x``, this rank's block under ``spec``, over ``axes``
        (default: every axis of ``spec``): the block under ``spec`` with
        ``axes`` removed. On each dim the removed axes must end its tuple
        (the minor ones), so the gathered block is contiguous."""
        dims = spec_axes(spec, x.ndim)
        if axes is None:
            axes = [a for d in dims for a in d]
        axes = [a for a in self.axis_names if a in axes]
        if not axes or self.axis_size(axes) == 1:
            return x
        removed = []
        for d in dims:
            gone = tuple(a for a in d if a in axes)
            if gone and d[len(d) - len(gone):] != gone:
                raise ValueError(f"cannot gather {gone} out of the joint axis {d}")
            removed.append(gone)
        members = self.members(axes)
        parts = self._all_gather(x.contiguous(), axes)
        counts = tuple(self.axis_size(g) for g in removed)
        grid = np.empty(counts, dtype=object)
        for r, part in zip(members, parts):
            c = self.coords_of(r)
            grid[tuple(self.index(g, c) for g in removed)] = part
        out = _assemble(grid)
        self._count("all_gather", out)
        return out

    # -- collectives --------------------------------------------------------

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """A sum over ``axes`` outside autograd (a new tensor)."""
        x = x.clone()
        if axes and self.axis_size(axes) > 1:
            self._all_reduce(x, axes)
            self._count("all_reduce", x)
        return x

    def _all_gather(self, x: torch.Tensor, axes: Sequence[str]) -> List[torch.Tensor]:
        """The blocks of the ranks of ``members(axes)``, in its order."""
        raise NotImplementedError

    def _all_reduce(self, x: torch.Tensor, axes: Sequence[str]) -> None:
        """Sum ``x`` in place over the ranks of ``members(axes)``."""
        raise NotImplementedError

    def _count(self, kind: str, x: torch.Tensor) -> None:
        self.traffic[kind]["calls"] += 1
        self.traffic[kind]["bytes"] += x.numel() * x.element_size()

    def psum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """Sum of the ranks' partial ``x`` over ``axes``, replicated; the
        replicated cotangent passes through to each partial."""
        if not axes or self.axis_size(axes) == 1:
            return x
        return _PSum.apply(x, self, tuple(axes))

    def pbroadcast(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """``x``, replicated over ``axes``, about to be used differently on
        each rank: the identity, whose backward sums the cotangents."""
        if not axes or self.axis_size(axes) == 1:
            return x
        return _PBroadcast.apply(x, self, tuple(axes))

    def pgather(self, x: torch.Tensor, dim: int, axes: Sequence[str]) -> torch.Tensor:
        """``x``, this rank's block along ``dim`` of a value split over
        ``axes``, gathered whole and about to be used differently on each
        rank: the backward sums the cotangents over ``axes`` and returns this
        rank's block of the sum."""
        if not axes or self.axis_size(axes) == 1:
            return x
        return _PGather.apply(x, self, dim % x.ndim, tuple(axes))


class BoundMesh(RankView):
    """A :class:`Mesh` laid over the ranks ``0 .. size-1`` of the default
    process group (see the module docstring). Every rank of the group
    makes the same groups in the same order at construction."""

    def __init__(self, mesh: Mesh):
        import torch.distributed as dist

        if not dist.is_initialized() or dist.get_world_size() != mesh.size:
            raise ValueError(
                f"a {mesh.axis_sizes} mesh needs a process group of {mesh.size} ranks; "
                f"have {dist.get_world_size() if dist.is_initialized() else 0}")
        super().__init__(mesh, dist.get_rank())
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        ids = mesh.devices
        for n in range(1, len(mesh.axis_names) + 1):
            for axes in itertools.combinations(mesh.axis_names, n):
                moved = [mesh.axis_names.index(a) for a in axes]
                kept = [i for i in range(ids.ndim) if i not in moved]
                # one group for every coordinate of the axes not in ``axes``
                blocks = np.transpose(ids, kept + moved).reshape(-1, int(np.prod(
                    [ids.shape[i] for i in moved])))
                for members in blocks:
                    members = sorted(int(r) for r in members)
                    group = dist.new_group(members)
                    if self.rank in members:
                        self._groups[axes] = (group, members)

    def group(self, axes: Sequence[str]):
        """(process group, its ranks in group-rank order) of the ranks that
        share this rank's coordinates off ``axes``."""
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]

    def _all_gather(self, x, axes):
        import torch.distributed as dist

        group, members = self.group(axes)
        parts = [torch.empty_like(x) for _ in members]
        dist.all_gather(parts, x, group=group)
        return parts

    def _all_reduce(self, x, axes):
        import torch.distributed as dist

        dist.all_reduce(x, group=self.group(axes)[0])


class TracedMesh(RankView):
    """Rank ``rank``'s view of ``mesh`` with no process group, for tracing
    one rank's step (``analysis.program.trace_step``): every line is
    :class:`RankView`'s, the collectives' counts included, but an
    all_gather assembles ``torch.empty_like`` parts (meta in, meta out)
    and an all_reduce leaves its clone as it is. ``on_collective(kind, operand,
    result, members)``, when set, hears of each collective with its operand,
    its result and the ranks it spans."""

    def __init__(self, mesh: Mesh, rank: int = 0):
        super().__init__(mesh, rank)
        self.on_collective = None
        self._operand = None

    def _all_gather(self, x, axes):
        self._operand = x, axes
        return [torch.empty_like(x) for _ in range(self.axis_size(axes))]

    def _all_reduce(self, x, axes):
        self._operand = x, axes

    def _count(self, kind: str, x: torch.Tensor) -> None:
        super()._count(kind, x)
        if self.on_collective is not None:
            operand, axes = self._operand
            self.on_collective(kind, operand, x, self.members(axes))


def _assemble(grid: np.ndarray, dim: int = 0) -> torch.Tensor:
    """Concatenate an N-d grid of blocks, grid dim i along tensor dim
    ``dim + i``."""
    if grid.ndim == 1:
        return torch.cat(list(grid), dim=dim)
    return torch.cat([_assemble(grid[i], dim + 1) for i in range(grid.shape[0])], dim=dim)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PBroadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axes), None, None


class _PGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axes):
        ctx.mesh, ctx.dim, ctx.axes, ctx.n = mesh, dim, axes, x.shape[dim]
        return mesh.gather(x, _spec_at(dim, axes), axes)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.index(ctx.axes)
        return (ctx.mesh.all_reduce(g, ctx.axes).narrow(ctx.dim, i * ctx.n, ctx.n), None, None,
                None)


def _spec_at(dim: int, axes: Sequence[str]) -> tuple:
    """A spec that splits dim ``dim`` over ``axes`` and no other."""
    return (None,) * dim + (tuple(axes),)


def bind_mesh(mesh: Mesh) -> BoundMesh:
    """``mesh`` over the default process group's ranks (collective: every
    rank calls it, with the same mesh)."""
    return BoundMesh(mesh)


def trace_mesh(mesh: Mesh, rank: int = 0) -> TracedMesh:
    """Rank ``rank``'s view of ``mesh`` with no process group (see
    :class:`TracedMesh`)."""
    return TracedMesh(mesh, rank)
