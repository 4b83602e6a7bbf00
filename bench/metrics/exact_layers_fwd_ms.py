"""The exact GAT layers after layer 1 in the local step's forward
(``core/fedgat_model.py::layered_forward``: every layer l > 1, its skip
included): the mean stream time of the window's ``exact_layers`` spans
opened inside a ``forward`` span that a ``local_step`` span holds, in ms,
one a step. The program times these spans with a CUDA event at entry and
at exit (``SpanRecord.device_ns``); a program without them, or a model of
two layers (whose forward opens none), gives nothing. Moves
``train_round_s``."""

NAME = "exact_layers"


def under_step_forward(record, by_id) -> bool:
    """``record`` sits in a ``forward`` span inside a ``local_step``."""
    parent = by_id.get(getattr(record, "parent_id", None))
    return parent is not None and parent.name == "forward" and parent.parent == "local_step"


def read(ctx):
    times = []
    for c in ctx.calls:
        spans = c.get("spans") or ()
        by_id = {r.span_id: r for r in spans if hasattr(r, "span_id")}
        times += [r.device_ns for r in spans
                  if r.name == NAME and getattr(r, "device_ns", None) is not None
                  and under_step_forward(r, by_id)]
    return sum(times) / len(times) / 1e6 if times else None
