"""auction_bids.train (layer Kernels): the auction's row bids a train step
of the traced window, from the program's own count
(``fenet_torch.ops.emd.auction_work``: the rows that bid, summed over a
call's elements, phases and iterations), which counts only while a
profiler records, so only the window's calls. None from a program that
does not count."""


def read(ctx, win):
    try:
        from fenet_torch.ops.emd import auction_work
    except ImportError:
        return None
    work, steps = auction_work(ctx.device), win.extra.get("steps")
    return work["bids"] / steps if work["calls"] and steps else None
