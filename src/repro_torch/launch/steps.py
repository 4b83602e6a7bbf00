"""Step builders shared by the train and serve CLIs and the dry-run (the
port of ``repro/launch/steps.py``): the train step (loss, grads, clipping,
AdamW), the prefill step and the decode step, and ``build_sharded_step``,
which lays each of them over a mesh with its placements.

A sharded step runs on the ranks of a bound mesh (``launch.mesh``), one
process a rank, each holding of every param, moment, batch and cache leaf
the block its placement gives it, and computes its rows of the batch
(split over the data axes).

Under megatron and zero1 the step is tensor parallel over the ``model``
axis, as GSPMD partitions the reference's program: a rank computes with
its own blocks (``models/layers.py``'s regions: column-split products,
row-split products summed over ``model``, the vocab-parallel embedding,
head and cross entropy, the expert-parallel MoE) and its cache blocks (KV
heads, RWKV's state heads, Mamba's channels), and gathers no param leaf,
but for the few whose blocks the model cannot compute with
(:func:`tp_gathers`: a block that cuts inside a head, Mamba's
``in_proj``). Under fsdp a rank gathers each param leaf over its spec's
axes and computes whole layers.

The few reductions over the batch sum over its split (``pspec.split``), so
the loss is the global one on every rank; the grads of each rank's blocks
are summed over the split (``all_reduce``), clipped by the global norm
(each block's squares summed over the ranks whose blocks differ) and
applied by AdamW to each rank's block of the moments (zero1's finer blocks
are all-gathered back to the param block). Outputs are cut, or gathered
over the axes their placement does not split, to their placements. The
step computes what the single-device step computes, up to rounding, with
the batch split into as many parts as the reference's sharded step splits
it (see ``build_sharded_step``).
"""
from __future__ import annotations

import copy
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
from repro_torch.models.rwkv import RWKVState
from repro_torch.optim.adamw import AdamState, adam_update, clip_by_global_norm

LR = 3e-4
WD = 0.1


def adam_init_f32(params_shape: Any) -> AdamState:
    """Adam moments in float32 whatever the (bf16) param dtype: the
    production mixed-precision layout. After the first update the params
    are float32 too, as in the reference."""
    device = tree_leaves(params_shape)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=device)  # noqa: E731
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu=tree_map(zeros, params_shape),
        nu=tree_map(zeros, params_shape),
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


def tp_gathers(cfg: ArchConfig, path: str, spec, mesh) -> bool:
    """The explicit gather rule of a tensor-parallel step: whether a param
    leaf's block on the ``model`` axis is one the model cannot compute with,
    so that each rank gathers the leaf whole and uses the part it needs:

    * an attention projection (``wq``, ``wk``, ``wv``: weight or bias) whose
      heads do not divide the axis while its width does, so its block cuts
      inside a head: reduced paligemma-3b's single KV head on (1, 2); at
      model 16 the KV heads of chatglm3-6b (2), yi-6b (4), granite, dbrx,
      qwen2 and minitron (8), hymba-1.5b's 25 query and 5 KV heads and
      paligemma-3b's 8 query heads and single KV head;
    * Mamba's ``in_proj``, whose contiguous column blocks do not hold the
      matching channels of its x and z halves (at model 2 rank 0 holds all
      of x, rank 1 all of z).
    """
    if mesh.shape.get("model", 1) == 1 or "model" not in {
            a for d in spec_axes(spec, len(spec)) for a in d}:
        return False
    parts = path.split("/")
    if "in_proj" in parts:
        return True
    if len(parts) >= 3 and parts[-3].endswith("attn") and parts[-2] in ("wq", "wk", "wv"):
        heads = cfg.num_heads if parts[-2] == "wq" else cfg.num_kv_heads
        return heads % mesh.shape["model"] != 0
    return False


def _computed(spec, ndim: int, axes, block: bool) -> P:
    """The spec of a cache leaf as a rank reads and writes it: its rows split
    over ``axes`` (dim 1), and with ``block`` its placement's split over
    ``model`` (the heads or channels the rank computes)."""
    out = []
    for i, d in enumerate(spec_axes(spec, ndim)):
        out.append((tuple(axes) or None) if i == 1 else
                   "model" if block and "model" in d else None)
    return P(*out)


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
        p_specs, p_shard = args[0], in_sh[0]
        self._p_full = [tuple(x.shape) for x in tree_leaves(p_specs)]
        self._p_spec = [sh.spec for sh in tree_leaves(p_shard)]
        paths = tree_leaves(shd.map_with_path(lambda path, sh: path, p_shard))
        # the param leaves a tensor-parallel rank gathers (tp_gathers); the
        # others it computes with as its blocks (``kept``; fsdp keeps none)
        self.gathered = [path for path, spec in zip(paths, self._p_spec)
                         if self.active is not None and tp_gathers(cfg, path, spec, mesh)]
        self.kept = [self.active is not None and path not in self.gathered for path in paths]

    # -- pieces ------------------------------------------------------------

    def on(self, view) -> "ShardedStep":
        """This step on ``view``, a rank's view of the same mesh (a
        ``launch.mesh.trace_mesh``, to trace the rank's program)."""
        if dict(view.shape) != dict(self.mesh.shape):
            raise ValueError(f"a step built for {dict(self.mesh.shape)} cannot run on "
                             f"{dict(view.shape)}")
        step = copy.copy(self)
        step.mesh = view
        step.active = None if self.active is None else view
        return step

    def _bound(self):
        if not hasattr(self.mesh, "gather"):
            raise ValueError("a sharded step runs on a mesh bound to the process group "
                             "(launch.mesh.bind_mesh) or traced (launch.mesh.trace_mesh); "
                             "this one is a description")
        return self.mesh

    def _views(self, bm, params):
        """The param tree a rank computes with: the kept leaves as this
        rank's blocks, the others gathered over their spec's axes."""
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
        """``x``, this rank's block under ``frm``, as its block under ``to``:
        gathered over the axes ``to`` does not split alike, then cut."""
        n = len(full_shape)
        keep, gone = [], []
        for f, t in zip(spec_axes(frm, n), spec_axes(to, n)):
            i = 0
            while i < min(len(f), len(t)) and f[i] == t[i]:
                i += 1
            keep.append(f[:i] or None)
            gone += f[i:]
        if gone:
            x, frm = bm.gather(x, frm, gone), P(*keep)
        return bm.block(x, frm, to, full_shape)

    def _cache_blocks(self):
        """Per cache leaf: whether this rank computes with its block of the
        placement's ``model`` split (a tensor-parallel step's heads and
        channels) or with the whole (fsdp; RWKV's token-shift inputs, which
        feed the replicated mixes)."""
        blocks = map_tree(lambda sh: self.active is not None, self.out_sh[1])
        if isinstance(getattr(blocks, "ssm", None), RWKVState):
            blocks = blocks._replace(ssm=blocks.ssm._replace(x_prev_tm=False, x_prev_cm=False))
        return blocks

    def _outputs(self, bm, logits, cache, axes):
        """Logits and cache, computed on this rank's rows (batch dim 0 and 1)
        and blocks (the vocab; the cache's heads and channels), cut or
        gathered to their placements."""
        full = tuple(self.out_specs[0].shape)
        vocab = "model" if logits.shape[-1] < full[-1] else None
        logits = self._reshard(bm, logits, P(tuple(axes) or None, None, vocab),
                               self.out_sh[0].spec, full)
        cache = map_tree(
            lambda x, sh, spec, block: self._reshard(
                bm, x, _computed(sh.spec, x.ndim, axes, block), sh.spec, tuple(spec.shape)),
            cache, self.out_sh[1], self.out_specs[1], self._cache_blocks())
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

        def view(x, sh, block):   # gathered to the spec the model computes with
            keep = spec_axes(_computed(sh.spec, x.ndim, axes, block), x.ndim)
            rest = [a for d, k in zip(spec_axes(sh.spec, x.ndim), keep) for a in d
                    if a not in k]
            return bm.gather(x, sh.spec, rest) if rest else x

        cache = map_tree(view, cache, self.in_sh[1], self._cache_blocks())
        with pspec.running(self.active, bm, axes):
            logits, cache = self.model.decode_step(views, cache, token)
        return self._outputs(bm, logits, cache, axes)


def build_sharded_step(cfg: ArchConfig, shape: InputShape, mesh, strategy: str = "megatron",
                       microbatches: int = 1):
    """Returns ``(fn, arg_specs, in_shardings, out_shardings)``, as the
    reference's (arg specs are meta tensors).

    strategy: "megatron" (batch on data axes, tensor/expert/vocab parallel on
    model: each rank computes with its own param blocks, gathering only the
    leaves ``tp_gathers`` names, listed in ``fn.gathered``), "zero1"
    (megatron + optimizer state sharded over data — ZeRO-1), or "fsdp"
    (params sharded over all axes and gathered whole in the step, batch over
    all axes; the active mesh is cleared, so its MoE takes the dense path).
    ``microbatches > 1`` adds gradient accumulation over slices of the
    global batch, each split over the mesh like the batch.

    ``fn`` runs on a mesh bound to the process group (``mesh.bind_mesh``)
    and takes and returns each rank's blocks; on a description it only
    describes (``fn.on(mesh.trace_mesh(desc, rank))`` runs one rank's
    program with no group, as ``analysis.program.trace_step`` does). It
    computes what the single-device step computes on the
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
