"""auction_iters.train (layer Kernels): the auction's iterations a train
step of the traced window, those of the call's longest element (one CTA an
element on the card: its chain of iterations sets the call's time), from
the program's own count (``fenet_torch.ops.emd.auction_work``), which
counts only while a profiler records, so only the window's calls. None
from a program that does not count."""


def read(ctx, win):
    try:
        from fenet_torch.ops.emd import auction_work
    except ImportError:
        return None
    work, steps = auction_work(ctx.device), win.extra.get("steps")
    return work["iterations"] / steps if work["calls"] and steps else None
