"""Step builders shared by the train and serve CLIs and the dry-run (the
port of ``repro/launch/steps.py``): the train step (loss, grads, clipping,
AdamW), the prefill step and the decode step, and ``build_sharded_step``,
which lays each of them over a mesh with its placements.

A sharded step runs on the ranks of a bound mesh (``launch.mesh``), one
process a rank, each holding of every param, moment, batch and cache leaf
the block its placement gives it. Within a step a rank gathers each param
leaf over its spec's axes (``all_gather``) and computes its rows of the
batch with the full weights; under megatron and zero1 the MoE's expert
leaves are not gathered, since the expert-parallel ``moe_ffn_sharded``
consumes each rank's block of the expert axis. The few reductions over the
batch sum over its split (``pspec.split``), so the loss is the global one
on every rank; the grads are summed over the split (``all_reduce``), clipped
by the global norm and applied by AdamW to each rank's block of the
moments (zero1's finer blocks are all-gathered back to the param block).
Outputs are cut, or all-gathered and cut, to their placements. The step
computes what the single-device step computes, up to rounding, with the
batch split into as many parts as the reference's sharded step splits it
(see ``build_sharded_step``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch._tree import tree_leaves, tree_map, tree_unflatten
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch import pspec
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import spec_axes
from repro_torch.launch.sharding import P, NamedSharding, map_tree
from repro_torch.launch.specs import (
    cache_specs,
    cfg_for_shape,
    input_specs,
    param_specs,
    prefill_cache_specs,
)
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamState, adam_update, clip_by_global_norm

LR = 3e-4
WD = 0.1


def adam_init_f32(params: Any) -> AdamState:
    """Adam moments in float32 whatever the (bf16) param dtype: the
    production mixed-precision layout. After the first update the params
    are float32 too, as in the reference."""
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device)  # noqa: E731
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def value_and_grad(loss_fn, params: Any, batch: Dict) -> Tuple[torch.Tensor, Dict, Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)(params, batch)``: the
    loss, its parts and a gradient tree in the params' dtypes (zeros for a
    leaf the loss does not reach)."""
    xs = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, parts = loss_fn(tree_unflatten(params, xs), batch)
    grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, xs)]
    parts = {k: v.detach() for k, v in parts.items()}
    return loss.detach(), parts, tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, microbatches: int = 1):
    """loss + grad + clip + AdamW. ``microbatches > 1`` accumulates grads
    over that many slices of the batch's axis 0 (summed in the params'
    dtypes, then divided), shrinking the live activations by the same
    factor. Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, loss)``."""
    model = build_model(cfg)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, _, grads = value_and_grad(model.loss, params, batch)
        else:
            def split(x, i):
                n = x.shape[0] // microbatches
                return x[i * n:(i + 1) * n]

            gsum = tree_map(torch.zeros_like, params)
            lsum = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
            for i in range(microbatches):
                mbatch = {k: split(v, i) for k, v in batch.items()}
                lv, _, g = value_and_grad(model.loss, params, mbatch)
                gsum = tree_map(torch.add, gsum, g)
                lsum = lsum + lv
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
        grads = clip_by_global_norm(grads, 1.0)
        new_params, new_opt = adam_update(grads, opt_state, params, LR, weight_decay=WD)
        return new_params, new_opt, loss

    return train_step


def make_prefill_step(cfg: ArchConfig, cache_len: int):
    model = build_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        b = dict(batch)
        b["cache_len"] = cache_len
        return model.prefill(params, b)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    model = build_model(cfg)

    @torch.no_grad()
    def decode_step(params, cache, token):
        return model.decode_step(params, cache, token)

    return decode_step


# ---------------------------------------------------------------------------
# Sharded step assembly (for the dry-run and runs on a bound mesh)
# ---------------------------------------------------------------------------

STRATEGIES = ("megatron", "zero1", "fsdp")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _common(spec, ndim: int, split) -> P:
    """``spec`` less the axes in ``split``, and on a joint dim every axis
    after the first of them: a block that contains this rank's, the same on
    every rank of the split's group."""
    out = []
    for d in spec_axes(spec, ndim):
        keep = []
        for a in d:
            if a in split:
                break
            keep.append(a)
        out.append(tuple(keep) or None)
    return P(*out)


def _refines(to, frm, ndim: int) -> bool:
    """Every dim's axes under ``frm`` begin its axes under ``to``: a block
    under ``to`` lies inside this rank's block under ``frm``."""
    return all(t[:len(f)] == f for t, f in zip(spec_axes(to, ndim), spec_axes(frm, ndim)))


ADAM_CHUNK_BYTES = 64 * 2**20    # the largest leading slice updated at once


def _adam_slices(g, m, v, p, step):
    """``adam_update`` of one leaf's blocks, in leading slices of at most
    ``ADAM_CHUNK_BYTES`` of moments, into the outputs (the update is
    elementwise: the same values, with temporaries of a slice's size)."""
    n = max(1, min(g.shape[0] if g.ndim else 1, -(-4 * g.numel() // ADAM_CHUNK_BYTES)))
    if n == 1:
        x, st = adam_update(g, AdamState(step, m, v), p, LR, weight_decay=WD)
        return x, st.mu, st.nu
    outs, rows = None, g.shape[0]
    for i in range(n):
        sl = slice(i * rows // n, (i + 1) * rows // n)
        x, st = adam_update(g[sl], AdamState(step, m[sl], v[sl]), p[sl], LR, weight_decay=WD)
        if outs is None:
            outs = [torch.empty(g.shape, dtype=t.dtype, device=t.device)
                    for t in (x, st.mu, st.nu)]
        for o, t in zip(outs, (x, st.mu, st.nu)):
            o[sl].copy_(t)
    return tuple(outs)


class ShardedStep:
    """One rank's train, prefill or decode step over a bound mesh (returned by
    :func:`build_sharded_step`; see the module docstring). ``out_specs``
    describes its outputs (meta tensors) as the builder's ``args`` its
    inputs."""

    def __init__(self, kind, cfg, shape, mesh, strategy, microbatches, args, in_sh, out_sh,
                 out_specs):
        self.kind, self.shape, self.mesh, self.microbatches = kind, shape, mesh, microbatches
        self.in_sh, self.out_sh, self.out_specs = in_sh, out_sh, out_specs
        self.model = build_model(cfg)
        self.active = None if strategy == "fsdp" else mesh
        self.batch_spec = shd.batch_spec_fsdp if strategy == "fsdp" else shd.batch_spec
        E = cfg.num_experts
        sharded_moe = (self.active is not None and "model" in mesh.axis_names
                       and E > 0 and E % mesh.shape["model"] == 0)
        p_specs, p_shard = args[0], in_sh[0]
        self._p_full = [tuple(x.shape) for x in tree_leaves(p_specs)]
        self._p_spec = [sh.spec for sh in tree_leaves(p_shard)]
        # per param leaf: one of the expert leaves moe_ffn_sharded consumes
        # as this rank's block of the expert axis (never gathered)
        self.kept = tree_leaves(shd.map_with_path(
            lambda path, sh: sharded_moe and "experts" in path and len(sh.spec) >= 3
            and sh.spec[len(sh.spec) - 3] == "model", p_shard))

    # -- pieces ------------------------------------------------------------

    def _bound(self):
        if not hasattr(self.mesh, "gather"):
            raise ValueError("a sharded step runs on a mesh bound to the process group "
                             "(launch.mesh.bind_mesh); this one is a description")
        return self.mesh

    def _views(self, bm, params):
        """The param tree a rank computes with: each leaf gathered over its
        spec's axes, the kept expert leaves as this rank's block."""
        leaves = [x if k else bm.gather(x, s)
                  for x, s, k in zip(tree_leaves(params), self._p_spec, self.kept)]
        return tree_unflatten(params, leaves)

    def _split(self, rows: int) -> Tuple[str, ...]:
        """The mesh axes a batch of ``rows`` is split over (its placement's)."""
        return spec_axes(self.batch_spec(self.mesh, (rows,)), 1)[0]

    def _rows(self, bm, batch, b_shard, start: int, rows: int):
        """This rank's part of rows [start, start + rows) of the whole batch,
        and the axes it is split over."""
        axes = self._split(rows)
        out = {}
        for k, v in batch.items():
            full = bm.gather(v, b_shard[k].spec)
            out[k] = bm.shard(full[start:start + rows], P(axes))
        return out, axes

    def _reshard(self, bm, x, frm, to, full_shape):
        if _refines(to, frm, len(full_shape)):
            return bm.block(x, frm, to, full_shape)
        return bm.shard(bm.gather(x, frm), to)

    def _outputs(self, bm, logits, cache, axes):
        """Logits and cache, computed on this rank's rows (batch dim 0 and 1),
        cut or gathered to their placements."""
        logits = self._reshard(bm, logits, P(axes), self.out_sh[0].spec,
                               tuple(self.out_specs[0].shape))
        cache = map_tree(
            lambda x, sh, spec: self._reshard(bm, x, P(None, axes) if x.ndim >= 2 else P(),
                                              sh.spec, tuple(spec.shape)),
            cache, self.out_sh[1], self.out_specs[1])
        return logits, cache

    # -- the three steps ---------------------------------------------------

    def __call__(self, *args):
        bm = self._bound()
        return {"train": self._train, "prefill": self._prefill, "decode": self._decode}[
            self.kind](bm, *args)

    def _train(self, bm, params, opt_state, batch):
        views = self._views(bm, params)
        mb = self.microbatches
        n = self.shape.global_batch // mb
        gsum, lsum = None, 0.0
        for i in range(mb):
            local, axes = self._rows(bm, batch, self.in_sh[2], i * n, n)
            with pspec.running(self.active, bm, axes):
                loss, _, grads = value_and_grad(self.model.loss, views, local)
            gsum = grads if gsum is None else tree_map(torch.add, gsum, grads)
            lsum = lsum + loss
        # Sum the grads over the split, each on the block of its leaf that
        # every rank of the split group needs: its param block less the
        # split's axes (and any minor to one of them on a joint dim).
        common = [_common(ps, len(full), axes) for ps, full in zip(self._p_spec, self._p_full)]
        g = [bm.all_reduce(bm.block(x, ps if k else P(), c, full), axes)
             for x, ps, k, c, full in zip(tree_leaves(gsum), self._p_spec, self.kept, common,
                                          self._p_full)]
        if mb > 1:
            g = [x / mb for x in g]
        loss = lsum / mb if mb > 1 else lsum
        # the global norm: each block's squares, summed over the ranks whose
        # blocks differ
        sq = {}
        for x, c in zip(g, common):
            key = tuple(a for d in spec_axes(c, x.ndim) for a in d)
            sq[key] = sq.get(key, 0.0) + torch.sum(x.to(torch.float32) ** 2)
        norm = torch.sqrt(sum(bm.all_reduce(v, key) for key, v in sq.items()))
        g = tree_leaves(clip_by_global_norm(g, 1.0, norm=norm))
        del views, gsum, grads
        # AdamW on this rank's block of the moments, leaf by leaf (a leaf's
        # grad is freed once it is applied); zero1's finer blocks are
        # all-gathered back to the param block
        m_spec = [sh.spec for sh in tree_leaves(self.in_sh[1].mu)]
        new_p, mu, nu = [], [], []
        for i, (p, m, v, c, ps, ms, full) in enumerate(zip(
                tree_leaves(params), tree_leaves(opt_state.mu), tree_leaves(opt_state.nu),
                common, self._p_spec, m_spec, self._p_full)):
            gi, g[i] = bm.block(g[i], c, ms, full), None
            x, m, v = _adam_slices(gi, m, v, bm.block(p, ps, ms, full), opt_state.step)
            del gi
            finer = [a for d in spec_axes(ms, x.ndim) for a in d
                     if a not in {b for e in spec_axes(ps, x.ndim) for b in e}]
            new_p.append(bm.gather(x, ms, finer) if finer else x)
            mu.append(m)
            nu.append(v)
        new_opt = AdamState(step=opt_state.step + 1, mu=tree_unflatten(opt_state.mu, mu),
                            nu=tree_unflatten(opt_state.nu, nu))
        return tree_unflatten(params, new_p), new_opt, loss

    @torch.no_grad()
    def _prefill(self, bm, params, batch):
        views = self._views(bm, params)
        B = self.shape.global_batch
        local, axes = self._rows(bm, batch, self.in_sh[1], 0, B)
        local["cache_len"] = self.shape.seq_len
        with pspec.running(self.active, bm, axes):
            logits, cache = self.model.prefill(views, local)
        return self._outputs(bm, logits, cache, axes)

    @torch.no_grad()
    def _decode(self, bm, params, cache, token):
        views = self._views(bm, params)
        axes = spec_axes(self.in_sh[2].spec, 2)[0]

        def view(x, sh):        # every axis but the batch split's (dim 1)
            dims = spec_axes(sh.spec, x.ndim)
            rest = [a for i, d in enumerate(dims) if i != 1 for a in d]
            return bm.gather(x, sh.spec, rest) if rest else x

        cache = map_tree(view, cache, self.in_sh[1])
        with pspec.running(self.active, bm, axes):
            logits, cache = self.model.decode_step(views, cache, token)
        return self._outputs(bm, logits, cache, axes)


def build_sharded_step(cfg: ArchConfig, shape: InputShape, mesh, strategy: str = "megatron",
                       microbatches: int = 1):
    """Returns ``(fn, arg_specs, in_shardings, out_shardings)``, as the
    reference's (arg specs are meta tensors).

    strategy: "megatron" (batch on data axes, tensor/expert on model),
    "zero1" (megatron + optimizer state sharded over data — ZeRO-1), or
    "fsdp" (params sharded over all axes, batch over all axes; the active
    mesh is cleared, so its MoE takes the dense path). ``microbatches > 1``
    adds gradient accumulation over slices of the global batch, each split
    over the mesh like the batch.

    ``fn`` runs on a mesh bound to the process group (``mesh.bind_mesh``)
    and takes and returns each rank's blocks; on a description it only
    describes. It computes what the single-device step computes on the
    same global batch, up to rounding, except where the reference's own
    sharded step splits the work: its expert-parallel MoE (megatron and
    zero1) routes, caps and averages its aux loss over each data shard's
    rows, as the single-device step does over each of as many microbatches.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    rcfg = cfg_for_shape(cfg, shape)
    p_specs = param_specs(cfg, shape)
    if strategy == "fsdp":
        p_shard = shd.param_shardings_fsdp(mesh, p_specs)
        bspec = shd.batch_spec_fsdp
    else:
        p_shard = shd.param_shardings(mesh, p_specs)
        bspec = shd.batch_spec
    inputs = input_specs(cfg, shape)
    repl = NamedSharding(mesh, P())
    b_shard = map_tree(lambda x: NamedSharding(mesh, bspec(mesh, tuple(x.shape))), inputs)
    B, V = shape.global_batch, rcfg.padded_vocab()

    def step(kind, args, in_sh, out_sh, out_specs):
        return ShardedStep(kind, rcfg, shape, mesh, strategy, microbatches, args, in_sh, out_sh,
                           out_specs)

    if shape.kind == "train":
        opt_specs = adam_init_f32(p_specs)
        opt_sh_fn = {"fsdp": shd.param_shardings_fsdp, "zero1": shd.opt_shardings_zero1,
                     "megatron": shd.param_shardings}[strategy]
        opt_shard = AdamState(step=repl, mu=opt_sh_fn(mesh, opt_specs.mu),
                              nu=opt_sh_fn(mesh, opt_specs.nu))
        args = (p_specs, opt_specs, inputs)
        in_sh = (p_shard, opt_shard, b_shard)
        out_sh = (p_shard, opt_shard, repl)
        # AdamW returns float32 params (a bf16 leaf times float32 moments)
        new_params = tree_map(lambda x: _meta(x.shape, torch.promote_types(x.dtype, torch.float32)),
                              p_specs)
        out_specs = (new_params, opt_specs, _meta((), torch.float32))
        return step("train", args, in_sh, out_sh, out_specs), args, in_sh, out_sh

    if shape.kind == "prefill":
        out_cache = prefill_cache_specs(cfg, shape)
        c_shard = shd.cache_shardings(mesh, rcfg, out_cache)
        args = (p_specs, inputs)
        in_sh = (p_shard, b_shard)
        out_sh = (repl, c_shard)
        out_specs = (_meta((B, 1, V), torch.float32), out_cache)
        return step("prefill", args, in_sh, out_sh, out_specs), args, in_sh, out_sh

    # decode
    c_specs = cache_specs(cfg, shape)
    c_shard = shd.cache_shardings(mesh, rcfg, c_specs)
    tok = inputs["tokens"]
    t_shard = NamedSharding(mesh, shd.batch_spec(mesh, tuple(tok.shape)))
    args = (p_specs, c_specs, tok)
    in_sh = (p_shard, c_shard, t_shard)
    out_sh = (NamedSharding(mesh, shd.batch_spec(mesh, (B, 1, 8))), c_shard)
    out_specs = (_meta((B, 1, V), torch.float32), c_specs)
    return step("decode", args, in_sh, out_sh, out_specs), args, in_sh, out_sh
