"""mfu.serve (layer Step): the folded model's forward FLOPs a request, by
the configuration's count (``counts/<reference>.py``), times the requests
answered a second in the traced window, over the card's bfloat16 peak, in
%. Padding rows of a batch count for nothing."""


def read(ctx, win):
    if win.trace is None or not win.work:
        return None
    rate = win.work / win.trace.window_s
    return 100.0 * ctx.counts.deploy_flops(ctx.config) * rate / ctx.peaks["bfloat16_flops_per_s"]
