"""icp_ms.eval (layer Alignment): wall ms a batch inside the eval step's
``align_pred_to_gt`` (``fenet_torch/geometry/icp.py``), from the
benchmark's span around that call in the traced window."""


def read(ctx, win):
    if win.trace is None or not win.extra["batches"]:
        return None
    seconds, calls = win.trace.span_s("portbench.icp")
    return seconds * 1e3 / win.extra["batches"] if calls else None
