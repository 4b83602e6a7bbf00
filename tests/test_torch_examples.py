"""The port's examples (``examples_torch/``) on the CPU, against the
reference's (``examples/``) where the output is exact:

* ``engines_and_privacy``: section 5's accountant lines equal the
  reference's printed lines verbatim (its section-5 code, run on the
  reference's accountant); section 1's engines agree with ``direct`` at the
  serving tolerances; section 3's masked round is within 1e-5 of the plain
  one;
* ``quickstart``: accuracies in [0, 1], and the communication line equal to
  the reference's comm report for the same config;
* ``e2e_federated_training``: a short run writes a checkpoint of the
  aggregated params;
* ``lm_train_smoke``: the loss falls over a few steps on a reduced arch,
  and the served tokens lie in the vocabulary.

Torch cannot draw ``jax.random``'s bits, so accuracies are held only for
range.
"""
import contextlib
import io
import pathlib
import re
import textwrap

import numpy as np
import torch

from examples_torch import e2e_federated_training, engines_and_privacy, lm_train_smoke
from examples_torch import quickstart

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVING_TOL = {"kernel": (1e-4, 1e-5), "vector": (1e-4, 1e-5),   # tests/test_fedgat_engines.py
               "matrix": (1e-3, 1e-4), "direct": (0.0, 0.0)}
MASK_TOL = 1e-5                                                  # tests/test_privacy.py:354-362


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def _reference_section5_lines():
    """The reference example's section 5, run verbatim on the reference's
    accountant."""
    from repro.privacy import compute_epsilon

    src = (ROOT / "examples" / "engines_and_privacy.py").read_text().splitlines()
    start = next(i for i, line in enumerate(src) if "=== 5. accountant" in line)
    end = next(i for i in range(start, len(src)) if src[i].strip() == "return 0")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        exec(textwrap.dedent("\n".join(src[start:end])), {"compute_epsilon": compute_epsilon})
    return buf.getvalue().splitlines()


def test_engines_and_privacy_on_the_cpu(monkeypatch):
    seen = {}

    def recorded(name):
        fn = getattr(engines_and_privacy, name)

        def call(*args, **kwargs):
            seen[name] = fn(*args, **kwargs)
            return seen[name]
        monkeypatch.setattr(engines_and_privacy, name, call)

    recorded("engine_logits")
    recorded("masked_round_drift")
    lines = _printed(engines_and_privacy.main, ["--device", "cpu"])
    start = lines.index("=== 5. accountant: epsilon composition ===")
    assert lines[start:] == [line for line in _reference_section5_lines() if line]
    want = seen["engine_logits"]["direct"]
    for engine, (rtol, atol) in SERVING_TOL.items():
        got = seen["engine_logits"][engine]
        assert got.shape == want.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=engine)
    assert 0.0 <= seen["masked_round_drift"] <= MASK_TOL
    eps = [line for line in lines if re.match(r"^\s+\d\.\d\s+", line)]
    assert [line.split()[-1] for line in eps] == ["off", "42.13", "16.80", "3.19"]


def test_quickstart_on_the_cpu():
    from repro.core import FedGATConfig as JFedGATConfig
    from repro.federated import FederatedConfig as JFederatedConfig
    from repro.federated import run_federated as j_run_federated
    from repro.graphs import make_cora_like as j_make_cora_like

    lines = _printed(quickstart.main, ["--device", "cpu"])
    accs = [float(m) for line in lines for m in re.findall(r"test acc (\d\.\d+)", line)]
    assert len(accs) == 2 and all(0.0 <= a <= 1.0 for a in accs)
    # The reference's comm report for the same config (rounds=0: no training).
    ref = j_run_federated(j_make_cora_like("cora_like", seed=0), JFederatedConfig(
        method="fedgat", num_clients=8, beta=1.0, rounds=0, local_steps=3, lr=0.02,
        model=JFedGATConfig(engine="vector", degree=16)))["comm"]
    assert (f"pre-training communication: {ref.download_scalars:,} scalars "
            f"({ref.cross_client_edges} cross-client edges kept)") in lines
    assert lines[0] == "graph: 320 nodes, 919 edges, 7 classes, max degree 16"


def test_e2e_federated_training_writes_its_checkpoint(tmp_path):
    from repro_torch.checkpoint import load_checkpoint

    ckpt = tmp_path / "ckpt.npz"
    lines = _printed(e2e_federated_training.main, [
        "--device", "cpu", "--dataset", "tiny", "--clients", "4", "--rounds", "3",
        "--ckpt", str(ckpt)])
    assert lines[-1] == f"[ckpt] saved aggregated model to {ckpt}"
    assert sum(line.startswith("  round ") for line in lines) == 3
    flat, step = load_checkpoint(str(ckpt))
    assert step == 3 and flat and all(np.isfinite(np.asarray(v)).all() for v in flat.values())


def test_lm_train_smoke_loss_falls_on_a_reduced_arch():
    lines = _printed(lm_train_smoke.main, [
        "--device", "cpu", "--arch", "chatglm3-6b", "--steps", "6", "--batch", "2",
        "--seq-len", "32"])
    first, last = map(float, re.search(r"\[train\] loss (\S+) -> (\S+) ", lines[-2]).groups())
    assert np.isfinite([first, last]).all() and last < first
    from repro_torch.configs import get_config

    ids = [int(t) for t in re.findall(r"\d+", lines[-1].split(":", 1)[1])]
    vocab = get_config("chatglm3-6b").reduced().vocab_size
    assert len(ids) == 7 and all(0 <= t < vocab for t in ids)
