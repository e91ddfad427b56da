"""idle_share.train (layer Device): the share of the traced window in which
no kernel, copy or set ran on the card, in %."""


def read(ctx, win):
    return None if win.trace is None else win.trace.idle_percent()
