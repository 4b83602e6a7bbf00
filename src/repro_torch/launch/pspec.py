"""Activation sharding constraints that degrade gracefully (the port of
``repro/launch/pspec.py``), and the step's batch split.

The reference's ``constrain(x, *axes)`` fits a PartitionSpec to ``x``
from ``axes`` (:func:`fitted_spec`): only axis names present in the active
mesh and dims that divide the axis size are kept, everything else is None
(replicated); off a mesh it is a no-op. A constraint is a hint to GSPMD,
which partitions the reference's program. The port's layout is explicit:
under megatron and zero1 each rank computes with its param blocks, its
activations replicated over ``model`` between tensor-parallel regions
(``models/layers.py``: ``pbroadcast`` into a column-split product,
``psum`` out of a row-split one) and split over the data axes by batch
rows; the vocab-parallel logits and the cache's head and channel blocks
are gathered to their placements only at the step's end
(``launch/steps.py``). So ``constrain`` returns its input and the port's
models do not call it (the reference constrains its dense MoE's capacity
buffers).

The active mesh is what ``moe_ffn`` reads to take the expert-parallel
path, and what the layers read to compute with the rank's blocks
(``layers.tp_view``). :func:`running` records, while a sharded step runs, the active mesh
and the axes over which the rows of the batch in hand are split
(:func:`split` reads them); the few reductions over the batch (the cross
entropy's mean, the dense MoE's capacity, ranks and load statistics) then
sum over those axes, as XLA's partitioner does for the reference's
globally-typed arrays.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.launch.sharding import P

Axis = Union[str, tuple, None]

# Set by the step builders around a sharded step (the reference captures
# the mesh outside jit for the same reason: model code reads it).
_ACTIVE: dict = {"names": (), "shape": {}, "mesh": None}
_SPLIT: dict = {"mesh": None, "axes": ()}


def set_active_mesh(mesh) -> None:
    if mesh is None:
        _ACTIVE["names"], _ACTIVE["shape"], _ACTIVE["mesh"] = (), {}, None
    else:
        _ACTIVE["names"] = tuple(mesh.axis_names)
        _ACTIVE["shape"] = dict(mesh.shape)
        _ACTIVE["mesh"] = mesh


def active_mesh():
    """The mesh set by the step builder (None off a mesh)."""
    return _ACTIVE["mesh"]


def _mesh():
    if not _ACTIVE["names"]:
        return None
    return _ACTIVE


def _axis_size(mesh, name) -> int:
    if isinstance(name, tuple):
        return int(np.prod([mesh["shape"][n] for n in name]))
    return int(mesh["shape"][name])


def fitted_spec(shape: Sequence[int], *axes: Axis) -> Optional[P]:
    """The PartitionSpec ``constrain`` fits to a value of ``shape`` on the
    active mesh (None off a mesh)."""
    mesh = _mesh()
    if mesh is None:
        return None
    names = set(mesh["names"])
    fitted = []
    for dim, ax in zip(shape, axes):
        if ax is None:
            fitted.append(None)
            continue
        wanted = ax if isinstance(ax, tuple) else (ax,)
        present = tuple(a for a in wanted if a in names)
        if not present:
            fitted.append(None)
            continue
        present = present if len(present) > 1 else present[0]
        if dim % _axis_size(mesh, present) == 0:
            fitted.append(present)
        else:
            fitted.append(None)
    fitted += [None] * (len(shape) - len(fitted))
    return P(*fitted)


def constrain(x, *axes: Axis):
    """``x`` itself, its values unchanged; :func:`fitted_spec` gives the
    spec the reference would constrain it to."""
    return x


DATA = ("pod", "data")
MODEL = "model"


# ---------------------------------------------------------------------------
# The batch split of a running sharded step
# ---------------------------------------------------------------------------

def split() -> Tuple[object, Tuple[str, ...]]:
    """(bound mesh, the axes the batch rows are split over), or (None, ())."""
    return _SPLIT["mesh"], _SPLIT["axes"]


@contextlib.contextmanager
def running(active, bound, axes: Sequence[str]):
    """Within: ``active`` is the active mesh (None for fsdp, whose MoE takes
    the dense path), and the batch in hand is split over ``axes`` of the
    bound mesh ``bound``."""
    saved = dict(_ACTIVE), dict(_SPLIT)
    set_active_mesh(active)
    _SPLIT["mesh"], _SPLIT["axes"] = bound, tuple(axes)
    try:
        yield
    finally:
        _ACTIVE.update(saved[0])
        _SPLIT.update(saved[1])
