"""backward_ms.train (layer Model backward): device ms a step of the
operations that autograd's engine launched."""


def read(ctx, win):
    if win.trace is None or not win.extra["steps"]:
        return None
    return win.trace.device_s(layer="Model backward") * 1e3 / win.extra["steps"] or None
