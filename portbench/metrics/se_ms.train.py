"""se_ms.train (layer Model): device ms a train step of the squeeze-and-excite
gates' forward and backward in the traced window, from the program's own
count (``fenet_torch.models.repvgg.se_work``: CUDA events around each gate's
launches in the forward, and from its output gradient to its input gradient
in the backward), which counts only while a profiler records, so only the
window's steps. None from a program that does not count, from a model
without gates, and off CUDA, where the count has calls and no time."""


def read(ctx, win):
    try:
        from fenet_torch.models.repvgg import se_work
    except ImportError:
        return None
    work, steps = se_work(ctx.device), win.extra.get("steps")
    return work["ms"] / steps if work["calls"] and work["ms"] > 0 and steps else None
