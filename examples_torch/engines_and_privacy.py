"""FedGAT engines + the repro_torch.privacy subsystem, hands-on, on the GPU.

Walks the real privacy machinery end-to-end on a tiny graph:

  1. engine agreement — Matrix/Vector/kernel/direct produce the same logits;
  2. DP-FedAvg — clipped + noised client updates through the Trainer, with
     the RDP accountant's (epsilon, delta) for each noise level;
  3. secure aggregation — pairwise masks cancel in the FedAvg aggregate, so
     a masked round equals the unmasked round to float tolerance while the
     server only ever sees masked updates;
  4. pack DP — calibrated one-shot noise on the pre-communicated pack, and
     the utility it costs;
  5. the accountant — epsilon composing over rounds and shrinking with
     noise.

The port of ``examples/engines_and_privacy.py``. Keys are integer seeds
(``privacy.dp.mask_base_key``, ``pack_noise_key``); generators are
``torch.Generator``s on the device.

  PYTHONPATH=src python examples_torch/engines_and_privacy.py [--device cpu]
"""
import argparse
import sys
from typing import Dict

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import FedGAT, FedGATConfig, init_params, registered_engines
from repro_torch.core.fedgat_model import graph_tensors
from repro_torch.federated import FederatedConfig, PrivacyConfig, run_federated
from repro_torch.federated.trainer import param_tree
from repro_torch.graphs import make_cora_like
from repro_torch.privacy import (
    client_mask,
    compute_epsilon,
    noisy_pack,
    pack_release_steps,
    pack_sensitivities,
)
from repro_torch.privacy.dp import mask_base_key, pack_noise_key

ENGINES = ("direct", "matrix", "vector", "kernel")


def engine_logits(g, params, dev) -> Dict[str, np.ndarray]:
    """Section 1: each engine's logits on ``g`` (one precommunicated pack
    each; the ``kernel`` engine's forward is one ``cheb_attn`` launch)."""
    outs = {}
    for engine in ENGINES:
        model = FedGAT(FedGATConfig(degree=12, engine=engine), device=dev)
        model.precommunicate(torch.Generator(device=dev).manual_seed(1), g)  # the ONE comm round
        with torch.no_grad():
            outs[engine] = model.apply(params, g).cpu().numpy()
    return outs


def masked_round_drift(g, base, dev) -> float:
    """Section 3: max |masked - unmasked| over the params after one round."""
    one_round = {**base, "rounds": 1}
    clean = run_federated(g, FederatedConfig(**one_round), device=dev)
    masked = run_federated(
        g, FederatedConfig(**one_round, privacy=PrivacyConfig(secure_agg=True)), device=dev)
    return max(float((a - b).detach().abs().max()) for a, b in
               zip(clean["params"].parameters(), masked["params"].parameters()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="FedGAT engines and the privacy stack")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    g = make_cora_like("tiny", seed=0)
    params = init_params(torch.Generator().manual_seed(0), g.feature_dim, g.num_classes,
                         FedGATConfig(), device=dev)

    print(f"=== 1. engine agreement (registry: {registered_engines()}) ===")
    outs = engine_logits(g, params, dev)
    for engine in ENGINES:
        diff = np.abs(outs[engine] - outs["direct"]).max()
        print(f"  {engine:7s} max |logits - direct| = {diff:.2e}")

    base = dict(method="fedgat", num_clients=4, rounds=8, local_steps=2,
                model=FedGATConfig(engine="direct", degree=12))

    print("\n=== 2. DP-FedAvg: clipped + noised client updates ===")
    print("  sigma   clip   best_test   epsilon (delta=1e-5)")
    for sigma in (0.0, 0.5, 1.0, 4.0):
        priv = (PrivacyConfig() if sigma == 0.0 else
                PrivacyConfig(noise_multiplier=sigma, clip=0.5))
        res = run_federated(g, FederatedConfig(**base, privacy=priv), device=dev)
        eps = res["epsilon"]
        eps_s = "off" if eps is None else f"{eps:.2f}"
        print(f"  {sigma:5.1f}  {priv.clip:5.2f}   {res['best_test']:.3f}       {eps_s}")

    print("\n=== 3. secure aggregation: masks cancel in the aggregate ===")
    drift = masked_round_drift(g, base, dev)
    print(f"  masked vs unmasked FedAvg aggregate (one round): "
          f"max |diff| = {drift:.2e}  (exact in real arithmetic)")
    # ... while an individual client's shipped update is heavily masked:
    tmpl = [{k: torch.zeros_like(v) for k, v in layer.items()} for layer in param_tree(params)]
    m = client_mask(mask_base_key(0), 0, 0, np.ones(4, np.float32), tmpl, scale=1.0)
    print(f"  one client's mask magnitude: max |m| = "
          f"{max(float(x.abs().max()) for layer in m for x in layer.values()):.2f} "
          "(what the server actually receives is params + m)")

    print("\n=== 4. pack DP: noise on the one communicated payload ===")
    model = FedGAT(FedGATConfig(engine="matrix", degree=12), device=dev)
    pack = model.precommunicate(torch.Generator(device=dev).manual_seed(1), g)
    h = graph_tensors(g, dev)[0]
    sens = pack_sensitivities(pack, h)
    print(f"  per-tensor sensitivities: "
          + ", ".join(f"{k}={v:.2f}" for k, v in sens.items()))
    with torch.no_grad():
        clean_logits = model.apply(params, g)
        print("  sigma   layer-out max err   release epsilon (4-tensor joint)")
        for sigma in (0.01, 0.05, 0.2):
            model.pack = noisy_pack(pack_noise_key(0), pack, h, sigma)
            err = float((model.apply(params, g) - clean_logits).abs().max())
            eps = compute_epsilon(sigma, pack_release_steps(), 1.0, 1e-5)
            print(f"  {sigma:5.2f}   {err:12.4f}       {eps:10.1f}")

    print("\n=== 5. accountant: epsilon composition ===")
    print("  rounds:  " + "  ".join(
        f"T={t}: eps={compute_epsilon(1.0, t, 0.5, 1e-5):6.2f}"
        for t in (1, 10, 60)))
    print("  sigma :  " + "  ".join(
        f"s={s}: eps={compute_epsilon(s, 60, 0.5, 1e-5):6.2f}"
        for s in (1.0, 2.0, 4.0)))
    print("  subsampling q=0.25 vs 1.0 at sigma=1, T=60: "
          f"{compute_epsilon(1.0, 60, 0.25, 1e-5):.2f} vs "
          f"{compute_epsilon(1.0, 60, 1.0, 1e-5):.2f} (amplification)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
