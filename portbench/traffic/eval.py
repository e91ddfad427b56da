"""Evaluation traffic: the port's ``make_eval_step`` (forward, ICP onto the
gt, auction EMD and chamfer per sample) at the mix's batch, on a pool of
distinct seeded batches (uint8 images, object-like clouds) handed over as
host arrays, each batch's per-sample CD and EMD read back to the host as
``evaluate_dataset`` reads them.

ICP's work depends on the clouds, so every run gets the same pool and the
same weights, drawn from the mix's ``data_seed``, and the run's seed sets
the order of the batches and which of them are checked: the same set of
batches in another order. The weights have the decoder's output layers
scaled by the configuration's ``head_scale``, so that the clouds come out
at the gt's scale. After the window a sample of its batches, drawn from
the seed, is worked out again by the reference: the aligned clouds, CD
and EMD of every sample of those batches are compared, and, as the
configuration states float32 with TF32 off, the TF32 switches that the
program left on (none).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.autograd.profiler import record_function

from portbench import inputs, spans, tracing
from portbench.harness import Check, Window
from portbench.reference import icp as ref_icp
from portbench.reference import losses as ref_losses
from portbench.reference.precision import Operands, exact_float32, tf32_switches


def setup(ctx) -> dict:
    from fenet_torch.eval.runner import make_eval_step
    from fenet_torch.models.generator import Generator

    cfg, p, dev = ctx.config, ctx.params, ctx.device
    count, b, data = p["pool"], p["batch"], p["data_seed"]
    imgs = inputs.images(data, count * b, cfg["image_hw"], dev).cpu().numpy()
    pts = inputs.blob_clouds(data, count * b, cfg["num_points"], dev).cpu().numpy()
    pool = [(imgs[i * b:(i + 1) * b], pts[i * b:(i + 1) * b])
            for i in inputs.permutation(ctx.seed, count).tolist()]
    state0 = ctx.reference.init(cfg, inputs.stream_seed(data, inputs.WEIGHTS), dev,
                                head_scale=cfg["assumed"]["head_scale"])
    with torch.device(dev):
        gen = Generator(num_points=cfg["num_points"], backbone=cfg["backbone"],
                        fine_width=cfg["fine_width"], mid_width=cfg["mid_width"])
    gen.load_state_dict(state0, strict=True)
    step = make_eval_step(gen, device=dev, icp_iterations=p["icp_iterations"],
                          icp_tolerance=p["icp_tolerance"], icp_rel_tolerance=p["icp_rel_tolerance"],
                          icp_patience=p["icp_patience"], emd_eps=p["emd_eps"],
                          emd_iters=p["emd_iters"])
    for k in range(p["warmup_batches"]):  # cuDNN's plans and the kernels at this shape
        _run(step, pool[k % count])
    return {"pool": pool, "state0": state0, "step": step, "model": gen, "outputs": []}


def _run(step, batch):
    out = step(*batch)
    cd, emd = out["cd"].cpu().numpy(), out["emd"].cpu().numpy()  # as evaluate_dataset
    return out["pred"], cd, emd


def _batches(state, seconds=None, count=None):
    """Eval steps over the pool in turn, ``count`` of them or whole passes
    over the pool until ``seconds`` have passed: every window does the
    same work a pass. (batches, samples whose CD or EMD is not finite)."""
    done = bad = 0
    t0 = time.perf_counter()
    pool, outputs = state["pool"], state["outputs"]
    while (count is None or done < count) and (seconds is None or done % len(pool)
                                               or time.perf_counter() - t0 < seconds):
        with record_function("portbench.step"):
            pred, cd, emd = _run(state["step"], pool[done % len(pool)])
        outputs.append((done % len(pool), pred, cd, emd))
        bad += int(np.sum(~np.isfinite(cd)) + np.sum(~np.isfinite(emd)))
        done += 1
    return done, bad


def window(ctx, state) -> Window:
    p, dev = ctx.params, ctx.device
    tracing.sync(dev)
    opened, t0 = time.time(), time.perf_counter()
    if ctx.trace:
        from fenet_torch.eval import runner

        with spans.forward_of(state["model"], "portbench.model"), \
                spans.around(runner, "align_pred_to_gt", "portbench.icp"), \
                tracing.traced(ctx.tmp, dev) as held:
            batches, bad = _batches(state, count=p["trace_batches"])
    else:
        batches, bad = _batches(state, seconds=ctx.seconds)
    tracing.sync(dev)
    seconds = time.perf_counter() - t0
    return Window(opened, seconds, batches * p["batch"], batches * p["batch"], bad,
                  held["trace"] if ctx.trace else None, {"batches": batches})


def end_to_end(ctx, state, win: Window) -> dict:
    return {"eval_samples_per_s": win.work / win.seconds}


def reference_batch(ctx, state0: dict, images, gt, ops: Operands = Operands()):
    """(aligned clouds, CD x100, EMD x100) of one batch by the reference."""
    p, dev = ctx.params, ctx.device
    images = torch.as_tensor(images, device=dev)
    gt = torch.as_tensor(gt, device=dev, dtype=torch.float32)
    with torch.no_grad():
        pred = ctx.reference.forward(state0, images, ctx.config, False, ops)[2]
        aligned = ref_icp.align(pred, gt, p["icp_iterations"], p["icp_tolerance"],
                                p["icp_rel_tolerance"], p["icp_patience"], ops)
        ass = ref_losses.auction(aligned, gt, p["emd_eps"], p["emd_iters"], ops)
        emd = torch.sqrt(ref_losses.matched(aligned, gt, ass)).mean(dim=1) * 100.0
        d1, _ = ref_losses.nearest(aligned, gt, ops)
        d2, _ = ref_losses.nearest(gt, aligned, ops)
        cd = (d1.mean(dim=1) + d2.mean(dim=1)) * 100.0
    return aligned, cd.cpu().numpy(), emd.cpu().numpy()


def sample(ctx, count: int):
    """The window's batches that the reference works out again: up to the
    mix's ``check_batches``, drawn from the seed."""
    order = inputs.permutation(ctx.seed, count, inputs.KEEP)
    return sorted(order[:min(ctx.params["check_batches"], count)].tolist())


def compare(ctx, got, want):
    """got, want: lists of (aligned, cd, emd) of the same batches."""
    cloud = max(float((torch.as_tensor(g[0]).to(w[0].device) - w[0]).abs().max()
                      / w[0].abs().max()) for g, w in zip(got, want))
    cd = max(float(np.max(np.abs(g[1] - w[1]) / np.abs(w[1]))) for g, w in zip(got, want))
    emd = max(float(np.max(np.abs(g[2] - w[2]) / np.abs(w[2]))) for g, w in zip(got, want))
    lim = ctx.limits
    return [Check("aligned_cloud", cloud, lim["aligned_cloud"]),
            Check("cd_sample", cd, lim["cd_sample"]), Check("emd_sample", emd, lim["emd_sample"])]


def program_outputs(ctx, state) -> list:
    """(batch, aligned, cd, emd) of the window's sampled batches; the
    program's model and step freed."""
    outputs = state.pop("outputs")
    picked = [outputs[i] for i in sample(ctx, len(outputs))]
    state.pop("step", None)
    state.pop("model", None)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    state["picked"] = [k for k, _, _, _ in picked]
    return [(pred, cd, emd) for _, pred, cd, emd in picked]


def reference_outputs(ctx, state, ops: Operands = Operands()) -> list:
    with exact_float32():
        return [reference_batch(ctx, state["state0"], *state["pool"][k], ops)
                for k in state["picked"]]


def check(ctx, state, win: Window):
    switches = sum(tf32_switches().values())  # as the program left them
    got = program_outputs(ctx, state)
    return [Check("tf32_switches", float(switches), ctx.limits["tf32_switches"])] + \
        compare(ctx, got, reference_outputs(ctx, state))
