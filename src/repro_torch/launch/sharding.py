"""Logical sharding rules: parameter/batch/cache PartitionSpecs per arch (the
port of ``repro/launch/sharding.py``; the rules are copies).

2D/3D parallelism: batch on ("pod", "data"), tensor/expert/vocab on
"model". Rules are path-based over the parameter tree; any dimension that
does not divide its mesh axis falls back to replication (hymba's 25 heads,
paligemma's 8 heads). A rule reads only a mesh's ``axis_names`` and
``shape``, so it runs on a :class:`~repro_torch.launch.mesh.Mesh`
description as on a bound one, and a spec tree from
:mod:`repro_torch.launch.specs` (meta tensors) as on real values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig


class P(tuple):
    """A PartitionSpec: one entry per leading dim, each None (replicated),
    a mesh axis name, or a tuple of names (one dim over joint axes, the
    first major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class NamedSharding:
    """A placement: ``spec`` over ``mesh``."""
    mesh: Any
    spec: P


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure. Dicts,
    lists, tuples and NamedTuples keep their types; a None in ``tree`` (a
    family's absent cache part) stays None."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``fn(path, leaf)`` over a tree of dicts (a parameter tree), the path
    the reference's ``_path_str`` gives: keys joined by '/'."""
    if isinstance(tree, Mapping):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _axis_size(mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return int(np.prod([mesh.shape[n] for n in name]))
    return int(mesh.shape[name])


def _canon(axis) -> Any:
    """Unwrap 1-tuples: P(("data",)) and P("data") are the same sharding."""
    if isinstance(axis, tuple) and len(axis) == 1:
        return axis[0]
    return axis


def _fit(mesh, dim: int, axis) -> Any:
    """axis if dim divides the mesh axis size, else None (replicate)."""
    return _canon(axis) if dim % _axis_size(mesh, axis) == 0 else None


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def _param_spec(mesh, path: str, shape: Tuple[int, ...]) -> P:
    """PartitionSpec for one parameter leaf (trailing dims; any leading
    layer-stack axis is replicated)."""
    def spec(*trailing):
        lead = (None,) * (len(shape) - len(trailing))
        fitted = []
        for dim, ax in zip(shape[len(lead):], trailing):
            fitted.append(_fit(mesh, dim, ax) if ax else None)
        return P(*(lead + tuple(fitted)))

    mdl = "model"
    # --- embeddings: shard the vocab dimension ---
    if "embed" in path or "head" in path:
        return spec(mdl, None)
    # --- attention ---
    if any(f"{n}/" in path or path.endswith(n) for n in ("wq", "wk", "wv")):
        if path.endswith("/b"):
            return spec(mdl)
        return spec(None, mdl)
    if "wo" in path:
        if path.endswith("/b"):
            return spec(None)
        return spec(mdl, None)
    if path.endswith("a1") or path.endswith("a2"):
        return spec(None, None)
    # --- MoE: expert-parallel over "model" ---
    if "experts" in path:
        if "w_down" in path:
            return spec(mdl, None, None) if _fit(mesh, shape[-3], mdl) else spec(None, mdl, None)
        return spec(mdl, None, None) if _fit(mesh, shape[-3], mdl) else spec(None, None, mdl)
    if "router" in path:
        return spec(None, None)
    # --- dense MLP ---
    if "w_gate" in path or "w_up" in path:
        return spec(None, mdl)
    if "w_down" in path:
        return spec(mdl, None)
    # --- rwkv time mix ---
    if any(k in path for k in ("wr/", "wg/")) or path.endswith("wr/w") or path.endswith("wg/w"):
        return spec(None, mdl)
    if "cm_k" in path:
        return spec(None, mdl)
    if "cm_v" in path:
        return spec(mdl, None)
    if "cm_r" in path:
        return spec(None, None)
    if path.endswith("/u") or "w0" in path:
        return spec(mdl)
    if "wa/" in path:
        return spec(None, None)
    if "wb/" in path:
        return spec(None, mdl)
    # --- mamba ---
    if "in_proj" in path:
        return spec(None, mdl)
    if "conv_w" in path:
        return spec(None, mdl)
    if "conv_b" in path or "dt_bias" in path or path.endswith("/D"):
        return spec(mdl)
    if "w_dt" in path:
        return spec(None, mdl)
    if "w_B" in path or "w_C" in path or "A_log" in path:
        return spec(mdl, None)
    if "out_proj" in path:
        return spec(mdl, None)
    # --- norms, mixes, scalars ---
    return P(*([None] * len(shape)))


def param_shardings(mesh, params_shape: Any) -> Any:
    """NamedSharding tree matching a parameter (or spec) tree."""

    def leaf(path, x):
        return NamedSharding(mesh, _param_spec(mesh, path, tuple(x.shape)))

    return map_with_path(leaf, params_shape)


def opt_shardings_zero1(mesh, params_shape: Any) -> Any:
    """ZeRO-1: optimizer moments take the megatron param layout EXTENDED by
    the data axes on the model-sharded dim (or the largest dim when the
    param is replicated) — the f32 Adam state, 4x the bf16 params, stops
    being replicated across data shards."""
    dp = batch_axes(mesh)

    def leaf(path, x):
        shape = tuple(x.shape)
        base = _param_spec(mesh, path, shape)
        spec = list(base) + [None] * (len(shape) - len(base))
        # extend the model-sharded dim with the data axes if divisible
        for i, (dim, ax) in enumerate(zip(shape, spec)):
            if ax == "model":
                joint = ("model",) + dp
                if dim % _axis_size(mesh, joint) == 0:
                    spec[i] = _canon(joint)
                return NamedSharding(mesh, P(*spec))
        # replicated param: shard its largest divisible dim over data
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if spec[i] is None and shape[i] % _axis_size(mesh, dp) == 0 and shape[i] > 1:
                spec[i] = _canon(dp)
                break
        return NamedSharding(mesh, P(*spec))

    return map_with_path(leaf, params_shape)


def param_shardings_fsdp(mesh, params_shape: Any) -> Any:
    """ZeRO-3/FSDP layout: every parameter sharded along its largest
    divisible dim over ALL mesh axes combined."""
    axes = tuple(mesh.axis_names)

    def leaf(path, x):
        if x.ndim == 0:
            return NamedSharding(mesh, P())
        dims = list(x.shape)
        order = sorted(range(x.ndim), key=lambda i: -dims[i])
        for i in order:
            if dims[i] % _axis_size(mesh, axes) == 0:
                spec = [None] * x.ndim
                spec[i] = axes
                return NamedSharding(mesh, P(*spec))
        return NamedSharding(mesh, P(*([None] * x.ndim)))

    return map_with_path(leaf, params_shape)


def batch_spec_fsdp(mesh, shape: Tuple[int, ...]) -> P:
    """Batch sharded over every mesh axis (pure data parallel)."""
    axes = tuple(mesh.axis_names)
    b = _fit(mesh, shape[0], axes)
    return P(*((b,) + (None,) * (len(shape) - 1)))


def batch_spec(mesh, shape: Tuple[int, ...]) -> P:
    """Token/label/prefix/frame arrays: batch on ("pod","data")."""
    dp = batch_axes(mesh)
    b = _fit(mesh, shape[0], dp)
    return P(*((b,) + (None,) * (len(shape) - 1)))


def batch_shardings(mesh, batch_shape: Any) -> Any:
    return map_tree(lambda x: NamedSharding(mesh, batch_spec(mesh, tuple(x.shape))),
                    batch_shape)


def cache_shardings(mesh, cfg: ArchConfig, cache_shape: Any) -> Any:
    """Decode caches (structure-aware). Batch-shard when divisible;
    otherwise shard the KV window over "data" (context parallelism for the
    global_batch=1 long-decode shape). KV heads / state channels go on
    "model" when divisible. A family's absent part (the port's None, the
    reference's literal 0) is replicated."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.encdec import EncDecCache
    from repro_torch.models.hybrid import MambaState
    from repro_torch.models.rwkv import RWKVState
    from repro_torch.models.transformer import DecodeCache

    dp = batch_axes(mesh)
    mdl = "model"

    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    def kv_cache(c: KVCache):
        # (L, B, W, KV, hd)
        b = _fit(mesh, c.k.shape[1], dp)
        w = None if b else _fit(mesh, c.k.shape[2], "data")
        kvh = _fit(mesh, c.k.shape[3], mdl)
        return KVCache(
            k=ns(None, b, w, kvh, None),
            v=ns(None, b, w, kvh, None),
            pos=ns(None, b, w),
        )

    def rwkv_state(s: RWKVState):
        b = _fit(mesh, s.S.shape[1], dp)
        h = _fit(mesh, s.S.shape[2], mdl)
        d = _fit(mesh, s.x_prev_tm.shape[2], mdl) if not b else None
        return RWKVState(
            x_prev_tm=ns(None, b, d),
            x_prev_cm=ns(None, b, d),
            S=ns(None, b, h, None, None),
        )

    def mamba_state(s: MambaState):
        b = _fit(mesh, s.h.shape[1], dp)
        di = _fit(mesh, s.h.shape[2], mdl)
        return MambaState(conv=ns(None, b, None, di), h=ns(None, b, di, None))

    def ssm(s):
        if isinstance(s, RWKVState):
            return rwkv_state(s)
        if isinstance(s, MambaState):
            return mamba_state(s)
        return ns()  # the absent part

    if isinstance(cache_shape, EncDecCache):
        return EncDecCache(
            self_kv=kv_cache(cache_shape.self_kv),
            cross_kv=kv_cache(cache_shape.cross_kv),
            pos=ns(),
        )
    return DecodeCache(
        kv=kv_cache(cache_shape.kv) if isinstance(cache_shape.kv, KVCache) else ns(),
        ssm=ssm(cache_shape.ssm),
        pos=ns(),
    )


def shard_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf's block on this rank (``jax.device_put`` of a whole value to
    its NamedSharding, on a bound mesh)."""
    return map_tree(lambda x, sh: sh.mesh.shard(x, sh.spec), tree, shardings)


def gather_tree(tree: Any, shardings: Any) -> Any:
    """Each leaf whole again from the ranks' blocks (collective)."""
    return map_tree(lambda x, sh: sh.mesh.gather(x, sh.spec), tree, shardings)
