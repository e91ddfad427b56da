"""mfu.eval (layer Step): the generator's forward FLOPs a sample, from the
configuration's shapes, times the traced window's samples a second, over
the card's float32 peak (TF32 is off), in %."""

from portbench.counts.generator import forward_flops


def read(ctx, win):
    if win.trace is None or not win.work:
        return None
    rate = win.work / win.trace.window_s
    return 100.0 * forward_flops(ctx.config) * rate / ctx.peaks["float32_flops_per_s"]
