"""mfu.eval (layer Step): the model's forward FLOPs a sample, by the
configuration's count (``counts/<reference>.py``), times the traced
window's samples a second, over the card's float32 peak (TF32 is off), in
%."""


def read(ctx, win):
    if win.trace is None or not win.work:
        return None
    rate = win.work / win.trace.window_s
    return 100.0 * ctx.counts.forward_flops(ctx.config) * rate / ctx.peaks["float32_flops_per_s"]
