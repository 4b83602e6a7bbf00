"""The harness's check fails a run whose timed path is broken underneath:
the look for a chip is skipped and everything else of a run is driven, on
the CPU at a small graph, with one fault planted in the program."""
import functools
import time

import pytest
import torch

from bench.harness import main

SEED = 2 ** 31 + 77
FAULTS = ["unchanged", "half_batch", "exchange", "answer", "one_leaf"]


def faulty(fault):
    """The program's names that ``fault`` replaces: (owner, name, stand-in)."""
    from repro_torch.core import fedgat_model
    from repro_torch.federated import cohort, trainer

    if fault == "unchanged":              # a local step returns its state unchanged
        adam = trainer.adam_update

        @functools.wraps(adam)
        def adam_update(grads, state, params, lr, **kw):
            _, new_state = adam(grads, state, params, lr, **kw)
            return params, new_state
        return [(trainer, "adam_update", adam_update)]
    if fault == "half_batch":           # half the labels left out, the mean over the rest
        ce = trainer.masked_cross_entropy

        def masked_cross_entropy(logits, labels, mask):
            m = mask.clone()
            m[torch.nonzero(m)[1::2, 0]] = False
            return ce(logits, labels, m)
        return [(trainer, "masked_cross_entropy", masked_cross_entropy)]
    if fault == "exchange":               # the exchange between clients left out
        update = cohort.running_update
        return [(trainer, "fedavg", lambda stacked: [
                    {k: v[0] for k, v in layer.items()} for layer in stacked]),
                (cohort, "running_update", lambda state, stacked, w, scale=1.0: update(
                    state, [{k: v[:1] for k, v in layer.items()} for layer in stacked], w[:1],
                    scale))]
    if fault == "one_leaf":             # one leaf's step taken 1% too long
        adam = trainer.adam_update

        @functools.wraps(adam)
        def adam_update(grads, state, params, lr, **kw):
            new_params, new_state = adam(grads, state, params, lr, **kw)
            old, new = params[-1]["W"], new_params[-1]["W"]
            new_params[-1]["W"] = old + 1.01 * (new - old)
            return new_params, new_state
        return [(trainer, "adam_update", adam_update)]
    if fault == "answer":               # an answer altered where it is produced
        forward = fedgat_model.layered_forward

        def layered_forward(*args):
            out = forward(*args)
            if torch.is_inference_mode_enabled():
                out = out.clone()
                out[0, 0] += 1.0
            return out
        return [(fedgat_model, "layered_forward", layered_forward)]
    raise ValueError(fault)


def plant(monkeypatch, fault):
    for owner, name, fn in faulty(fault):
        monkeypatch.setattr(owner, name, fn)


def plant_in_window(monkeypatch, fault):
    """``fault`` only in the calls after the first: the window's, never the
    warm call whose local steps are read."""
    from repro_torch.federated import trainer

    calls = [0]
    run = trainer.Trainer.run

    def counted_run(self, *args, **kwargs):
        calls[0] += 1
        return run(self, *args, **kwargs)
    monkeypatch.setattr(trainer.Trainer, "run", counted_run)
    for owner, name, fn in faulty(fault):
        sound = getattr(owner, name)

        def gated(*args, _fn=fn, _sound=sound, **kwargs):
            return (_fn if calls[0] > 1 else _sound)(*args, **kwargs)
        monkeypatch.setattr(owner, name, functools.wraps(sound)(gated))


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_comes_out_not_correct(tiny_cell, fault, monkeypatch):
    plant(monkeypatch, fault)
    result = main.run_cell(tiny_cell, SEED, 0.1, False, "cpu", time.perf_counter())
    assert result["correct"] is False, (fault, result["checks"])


@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_only_in_the_window_comes_out_not_correct(tiny_cell, fault, monkeypatch):
    plant_in_window(monkeypatch, fault)
    result = main.run_cell(tiny_cell, SEED + 1, 0.1, False, "cpu", time.perf_counter())
    assert result["correct"] is False, (fault, result["checks"])
    window = result["window"]
    assert window["judged"] == window["calls"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("fault", FAULTS)
def test_a_fault_only_in_the_window_comes_out_not_correct_on_the_card(fault, monkeypatch):
    """The same on the card, through the CUDA kernels, at the configurations'
    widths on a graph a test can hold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from conftest import cut_cell
    from test_bench_control import GRAPH

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    plant_in_window(monkeypatch, fault)
    for name in ("train.arxiv.kernel", "train.arxiv.vector", "train.arxiv.kernel.cohort-dp"):
        result = main.run_cell(cut_cell(name, GRAPH), SEED + 2, 0.1, False, "cuda:0",
                               time.perf_counter())
        assert result["correct"] is False, (name, fault, result["checks"])
