"""The skip of the GAT paper's inductive model in the local step's forward
(``core/fedgat_model.py::layered_forward``: ``x P`` per head and the add,
on each hidden layer after the first): the stream time of the window's
``skip`` spans inside an ``exact_layers`` span of a local step's forward,
summed a step and averaged over the steps, in ms. Device-timed spans, as
``exact_layers_fwd_ms`` reads; a program or a model without them gives
nothing. Moves ``train_round_s``."""

from bench.harness import spec

NAME, PARENT = "skip", "exact_layers"
under_step_forward = spec.load_module(spec.BENCH / "metrics" / "exact_layers_fwd_ms.py",
                                      "bench_metric_exact_layers_fwd_ms").under_step_forward


def read(ctx):
    per_step = {}
    for c in ctx.calls:
        spans = c.get("spans") or ()
        by_id = {r.span_id: r for r in spans if hasattr(r, "span_id")}
        for r in spans:
            if r.name != NAME or getattr(r, "device_ns", None) is None:
                continue
            layers = by_id.get(getattr(r, "parent_id", None))
            if layers is not None and layers.name == PARENT and under_step_forward(layers, by_id):
                per_step[layers.span_id] = per_step.get(layers.span_id, 0) + r.device_ns
    return sum(per_step.values()) / len(per_step) / 1e6 if per_step else None
