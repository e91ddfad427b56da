"""mfu.serve (layer Step): the folded generator's forward FLOPs a request,
from the configuration's shapes, times the requests answered a second in
the traced window, over the card's bfloat16 peak, in %. Padding rows of a
batch count for nothing."""

from portbench.counts.generator import deploy_flops


def read(ctx, win):
    if win.trace is None or not win.work:
        return None
    rate = win.work / win.trace.window_s
    return 100.0 * deploy_flops(ctx.config) * rate / ctx.peaks["bfloat16_flops_per_s"]
