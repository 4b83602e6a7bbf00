"""The port's train and serve CLIs: ``train lm``, ``train graph`` and the
serve CLI's default ``lm`` mode on the CPU, the checkpoint ``train lm``
writes, and the device rule (without ``--device cpu`` and without a card,
every entry point raises)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import load_checkpoint, unflatten
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import transformer as tf

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_train_lm_prints_losses_and_writes_a_reference_layout_checkpoint(capsys, tmp_path):
    ckpt = tmp_path / "lm.npz"
    train.main(["lm", "--arch", "granite-moe-1b-a400m", "--reduced", "--steps", "3",
                "--batch", "2", "--seq-len", "32", "--device", "cpu", "--ckpt", str(ckpt)])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if "loss=" in line]
    assert len(losses) == 2 and all(np.isfinite(losses)), out
    assert "device=cpu" in out and "saved checkpoint" in out
    flat, step = load_checkpoint(str(ckpt))
    assert step == 3
    assert {"params/embed/table", "params/head/table", "params/final_norm/scale",
            "params/layers/moe/experts/w_gate/w", "params/layers/moe/router/w"} <= set(flat)
    cfg = get_config("granite-moe-1b-a400m").reduced()
    params = params_from_numpy(unflatten(flat)["params"], device="cpu")
    assert params["layers"]["moe"]["experts"]["w_gate"]["w"].shape == (
        cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff)
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        assert bool(torch.isfinite(tf.lm_forward(params, cfg, tok)[0]).all())


def test_train_graph_prints_the_references_lines(capsys):
    train.main(["graph", "--dataset", "tiny", "--clients", "2", "--rounds", "4",
                "--engine", "direct", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "best_test=" in out and "pretrain_comm_scalars=" in out, out


@pytest.mark.parametrize("arch", ["yi-6b", "rwkv6-1.6b", "seamless-m4t-large-v2"])
def test_serve_defaults_to_lm_mode(capsys, arch):
    serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8",
                "--gen-len", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill: 8 tokens x 2" in out and "decode: 3 steps x 2 seqs" in out, out
    ids = out.split("generated token ids:")[1]
    toks = np.array([int(t) for t in ids.replace("[", " ").replace("]", " ").split()])
    vocab = get_config(arch).reduced().vocab_size
    assert toks.size == 8 and (toks >= 0).all() and (toks < vocab).all()


def test_serve_lm_greedy_tokens_follow_the_forward():
    """The first generated token is the argmax of the full forward's last
    position, and each later one the argmax after appending the previous
    (greedy decoding through the cache equals greedy on the full prefix)."""
    cfg = get_config("chatglm3-6b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    res = serve.serve_lm(model, params, {"tokens": prompt}, 4, cache_len=16)
    seq = prompt
    with torch.no_grad():
        for i in range(4):
            logits = tf.lm_forward(params, cfg, seq)[0][:, -1, : cfg.vocab_size]
            nxt = torch.argmax(logits, dim=-1)[:, None]
            assert torch.equal(nxt, res["tokens"][:, i:i + 1]), i
            seq = torch.cat([seq, nxt], dim=1)
    sampled = serve.serve_lm(model, params, {"tokens": prompt}, 4, cache_len=16,
                             temperature=0.8, generator=torch.Generator().manual_seed(2))
    again = serve.serve_lm(model, params, {"tokens": prompt}, 4, cache_len=16,
                           temperature=0.8, generator=torch.Generator().manual_seed(2))
    assert torch.equal(sampled["tokens"], again["tokens"])


@pytest.mark.parametrize("argv", [
    ["train", "lm", "--arch", "yi-6b", "--reduced", "--steps", "1"],
    ["train", "graph", "--dataset", "tiny", "--clients", "2", "--rounds", "1"],
    ["serve", "--arch", "yi-6b", "--reduced"],
    ["serve", "--mode", "graph", "--fast"],
], ids=["train-lm", "train-graph", "serve-lm", "serve-graph"])
def test_entry_points_raise_without_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    main = (train if argv[0] == "train" else serve).main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv[1:])


def test_module_entry_points_run_as_scripts():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "hymba-1.5b", "--reduced",
         "--batch", "1", "--prompt-len", "4", "--gen-len", "2", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    assert proc.returncode == 0, proc.stderr
    assert "prefill:" in proc.stdout and "decode:" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "lm", "--arch", "paligemma-3b",
         "--reduced", "--steps", "1", "--batch", "2", "--seq-len", "8"],
        capture_output=True, text=True, timeout=120, cwd=ROOT, env=env)
    if not torch.cuda.is_available():
        assert proc.returncode != 0 and "no CUDA device" in proc.stderr


def test_model_init_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    model = build_model(get_config("yi-6b").reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(2, 8)
