"""loss_ms.train (layer Losses): device ms a step of the operations
launched inside the trainer's loss (the benchmark's span around
``Trainer.loss``: chamfer, the auction or the Sinkhorn potentials and
plan), outside autograd's backward."""


def read(ctx, win):
    if win.trace is None or not win.extra["steps"]:
        return None
    ms = win.trace.device_s(layer="Losses", without="Model backward") * 1e3
    return ms / win.extra["steps"] or None
