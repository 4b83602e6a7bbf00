"""The harness's check fails a run whose timed path is broken underneath:
the look for a chip is skipped and everything else of a run is driven, on
the CPU at a small graph, with one fault planted in the program."""
import functools
import time

import pytest
import torch

from bench.harness import main

SEED = 2 ** 31 + 77


def plant(monkeypatch, fault):
    from repro_torch.core import fedgat_model
    from repro_torch.federated import cohort, trainer

    if fault == "unchanged":              # a local step returns its state unchanged
        adam = trainer.adam_update

        @functools.wraps(adam)
        def adam_update(grads, state, params, lr, **kw):
            _, new_state = adam(grads, state, params, lr, **kw)
            return params, new_state
        monkeypatch.setattr(trainer, "adam_update", adam_update)
    elif fault == "half_batch":           # half the labels left out, the mean over the rest
        ce = trainer.masked_cross_entropy

        def masked_cross_entropy(logits, labels, mask):
            m = mask.clone()
            m[torch.nonzero(m)[1::2, 0]] = False
            return ce(logits, labels, m)
        monkeypatch.setattr(trainer, "masked_cross_entropy", masked_cross_entropy)
    elif fault == "exchange":             # the exchange between clients left out
        monkeypatch.setattr(trainer, "fedavg", lambda stacked: [
            {k: v[0] for k, v in layer.items()} for layer in stacked])
        update = cohort.running_update
        monkeypatch.setattr(cohort, "running_update", lambda state, stacked, w, scale=1.0: update(
            state, [{k: v[:1] for k, v in layer.items()} for layer in stacked], w[:1], scale))
    elif fault == "one_leaf":             # one leaf's step taken 1% too long
        adam = trainer.adam_update

        @functools.wraps(adam)
        def adam_update(grads, state, params, lr, **kw):
            new_params, new_state = adam(grads, state, params, lr, **kw)
            old, new = params[-1]["W"], new_params[-1]["W"]
            new_params[-1]["W"] = old + 1.01 * (new - old)
            return new_params, new_state
        monkeypatch.setattr(trainer, "adam_update", adam_update)
    elif fault == "answer":               # an answer altered where it is produced
        forward = fedgat_model.layered_forward

        def layered_forward(*args):
            out = forward(*args)
            if torch.is_inference_mode_enabled():
                out = out.clone()
                out[0, 0] += 1.0
            return out
        monkeypatch.setattr(fedgat_model, "layered_forward", layered_forward)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "exchange", "answer", "one_leaf"])
def test_a_planted_fault_comes_out_not_correct(tiny_cell, fault, monkeypatch):
    plant(monkeypatch, fault)
    result = main.run_cell(tiny_cell, SEED, 0.1, False, "cpu", time.perf_counter())
    assert result["correct"] is False, (fault, result["checks"])
