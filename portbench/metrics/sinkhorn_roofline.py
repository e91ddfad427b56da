"""sinkhorn_roofline (layer Kernels): the Sinkhorn potentials' least time
over their device time, in %.

The work is counted from the traffic alone: the Sinkhorn loss solves for
its potentials once a step, and a solve's least time is the larger of its
operations over the card's float32 peak and its bytes over its memory
bandwidth, from the batch, the two clouds' points and the configured
iterations (``counts/sinkhorn.py``). The device time is that of every
operation launched inside the program's potentials call (layer Kernels:
in the training traffic only the benchmark's ``portbench.potentials`` span
around that call maps to it), however many launches and kernels the
program splits a solve into."""

from portbench.counts.sinkhorn import least_seconds

SOLVES_PER_STEP = 1


def read(ctx, win):
    if win.trace is None or not win.extra.get("steps"):
        return None
    device = win.trace.device_s(layer="Kernels", without="Model backward")
    if device <= 0:
        return None
    p, n = ctx.params, ctx.config["num_points"]
    least = least_seconds(p["batch"], n, n, p["sinkhorn_iters"], ctx.peaks["float32_flops_per_s"],
                          ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * win.extra["steps"] * SOLVES_PER_STEP * least / device
