"""The local step's backward on the device (``federated/trainer.py::grad_of``:
``torch.autograd.grad`` of a client's loss, the gathers' index backward
included): the mean stream time of the window's ``backward`` spans opened
inside a ``local_step`` span, in ms. The program times these spans with a
CUDA event at entry and at exit (``SpanRecord.device_ns``); a program
without them gives nothing. Moves ``train_round_s``."""

NAME, PARENT = "backward", "local_step"


def read(ctx):
    times = [r.device_ns for c in ctx.calls for r in c.get("spans") or ()
             if r.name == NAME and r.parent == PARENT
             and getattr(r, "device_ns", None) is not None]
    return sum(times) / len(times) / 1e6 if times else None
