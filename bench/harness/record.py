"""Reads what the program's training steps produce while one of its calls
runs, without changing what they compute.

The program's trainer builds its optimizer states inside each call and
returns only the round's global params and accuracies, so the set-up call
reads its local steps where the trainer module hands them on: the loss
that ``masked_cross_entropy`` returns, the state and params that
``adam_update`` returns, and the logits the evaluation passes to
``masked_accuracy``. The wrappers copy those values and return the
originals' results unchanged; they are in place only for the set-up call,
never in the measured window. A client's first gradient is worked out
from the optimizer's first moment after its first step, over ``1 - b1``
with the ``b1`` that step was called with. The reading needs the trainer
to call these three names through its module; a program that handed its
steps on itself would free the benchmark of that.

In the measured window ``WindowRecorder`` reads less: of every call, the
global params of its first round (a copy of ~10^4 floats on the device),
and of the last call that round's evaluation logits (copied to pinned
host memory without a wait), where ``setup_run`` and ``masked_accuracy``
of the trainer module hand them on.
"""
from __future__ import annotations

import inspect
import time
from types import ModuleType
from typing import List, Optional, Tuple

import torch

from bench.reference.fedgat import RoundReading


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a params tree (lists of mappings, or the result's
    ``ModuleList`` of ``ParameterDict``s) in order: layer by layer, by key."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "items"):
        return [leaf for _, v in tree.items() for leaf in tree_leaves(v)]
    return [leaf for t in tree for leaf in tree_leaves(t)]


class StepRecorder:
    """``with StepRecorder(trainer_module) as rec: run_federated(...)``."""

    NAMES = ("masked_cross_entropy", "adam_update", "masked_accuracy")

    def __init__(self, trainer: ModuleType):
        self.trainer = trainer
        self.losses: List[torch.Tensor] = []
        self.states: List[List[torch.Tensor]] = []    # first moments after each step
        self.b1s: List[float] = []                     # each step's first-moment decay
        self.params: List[List[torch.Tensor]] = []    # params after each step
        self.logits: Optional[torch.Tensor] = None
        self._saved = {}

    def __enter__(self) -> "StepRecorder":
        t = self.trainer
        self._saved = {n: getattr(t, n) for n in self.NAMES}
        ce, adam, acc = (self._saved[n] for n in self.NAMES)

        def masked_cross_entropy(logits, labels, mask):
            loss = ce(logits, labels, mask)
            self.losses.append(loss.detach().clone())
            return loss

        def adam_update(grads, state, params, lr, *args, **kwargs):
            new_params, new_state = adam(grads, state, params, lr, *args, **kwargs)
            call = inspect.signature(adam).bind(grads, state, params, lr, *args, **kwargs)
            call.apply_defaults()
            self.b1s.append(float(call.arguments["b1"]))
            self.states.append([m.detach().clone() for m in tree_leaves(new_state.mu)])
            self.params.append([p.detach().clone() for p in tree_leaves(new_params)])
            return new_params, new_state

        def masked_accuracy(logits, labels, mask):
            if self.logits is None:
                self.logits = logits.detach().clone()
            return acc(logits, labels, mask)

        t.masked_cross_entropy = masked_cross_entropy
        t.adam_update = adam_update
        t.masked_accuracy = masked_accuracy
        return self

    def __exit__(self, *exc) -> bool:
        for n, f in self._saved.items():
            setattr(self.trainer, n, f)
        return False

    def reading(self, clients: int, local_steps: int, global_params) -> RoundReading:
        """The round in the reference's terms; raises when the program did
        not run the steps the traffic asks for."""
        steps = clients * local_steps
        if len(self.losses) != steps or len(self.states) != steps or self.logits is None:
            raise RuntimeError(
                f"the program's round ran {len(self.losses)} losses and {len(self.states)} "
                f"optimizer steps (wanted {steps}), evaluation logits "
                f"{'read' if self.logits is not None else 'not read'}: the benchmark reads "
                "the trainer's masked_cross_entropy, adam_update and masked_accuracy")
        firsts = [c * local_steps for c in range(clients)]
        grad1 = [[m / (1 - self.b1s[i]) for m in self.states[i]] for i in firsts]
        local = [self.params[c * local_steps + local_steps - 1] for c in range(clients)]
        return RoundReading(
            losses=[float(x) for x in self.losses], grad1=grad1, local=local,
            global_params=[p.detach().clone() for p in tree_leaves(global_params)],
            eval_logits=self.logits)


class WindowRecorder:
    """``with WindowRecorder(trainer_module, logits_shape) as rec:`` around
    the window's calls. Each call's first evaluation hands on the round's
    global params (kept, one list of leaves a call, in ``params``) and its
    logits (copied over ``logits``, so the last call's stay). The copies
    are enqueued on the device's stream and never waited for; ``hook_s``
    is the host time spent in the wrappers, which the window pays."""

    def __init__(self, trainer: ModuleType, logits_shape: Tuple[int, ...], device):
        self.trainer = trainer
        cuda = torch.device(device).type == "cuda"
        self.logits = torch.empty(logits_shape, pin_memory=cuda)
        self.params: List[List[torch.Tensor]] = []
        self.hook_s = 0.0
        self._armed = False
        self._saved = {}

    def __enter__(self) -> "WindowRecorder":
        t = self.trainer
        self._saved = {n: getattr(t, n) for n in ("setup_run", "masked_accuracy")}
        setup_run, acc = self._saved["setup_run"], self._saved["masked_accuracy"]

        def setup_run_read(*args, **kwargs):
            run = setup_run(*args, **kwargs)
            evaluate, first = run.evaluate, [True]

            def evaluate_read(p):
                if not first[0]:
                    return evaluate(p)
                first[0] = False
                a = time.perf_counter()
                self.params.append([leaf.detach().clone() for leaf in tree_leaves(p)])
                self._armed = True
                self.hook_s += time.perf_counter() - a
                return evaluate(p)
            return run._replace(evaluate=evaluate_read)

        def masked_accuracy_read(logits, labels, mask):
            if self._armed:
                a = time.perf_counter()
                self._armed = False
                self.logits.copy_(logits.detach(), non_blocking=True)
                self.hook_s += time.perf_counter() - a
            return acc(logits, labels, mask)

        t.setup_run = setup_run_read
        t.masked_accuracy = masked_accuracy_read
        return self

    def __exit__(self, *exc) -> bool:
        for n, f in self._saved.items():
            setattr(self.trainer, n, f)
        return False
