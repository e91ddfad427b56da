"""optimizer_ms.train (layer Optimizer): device ms a step of the operations
launched inside torch's ``Optimizer.step`` range, the Adam update
(``layers.json`` maps that range to the layer; the trainer's
``fenet_torch.train.optimizer`` span holds it, and the learning-rate loop
and ``zero_grad(set_to_none=True)`` beside it launch nothing)."""


def read(ctx, win):
    if win.trace is None or not win.extra["steps"]:
        return None
    return win.trace.device_s(layer="Optimizer") * 1e3 / win.extra["steps"] or None
