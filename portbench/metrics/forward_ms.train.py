"""forward_ms.train (layer Model): device ms a step of the operations
launched inside the generator's forward (the benchmark's span around it),
outside autograd's backward."""


def read(ctx, win):
    if win.trace is None or not win.extra["steps"]:
        return None
    ms = win.trace.device_s(layer="Model", without="Model backward") * 1e3
    return ms / win.extra["steps"] or None
