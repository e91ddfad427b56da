"""Training traffic: the port's ``Trainer.train_step`` at the mix's batch,
on a pool of distinct seeded batches (uint8 images, uniform clouds) that
lie on the card, as a loader that prefetches to the card hands them over,
each step a new batch in turn. Every step's losses are read back, as
``Trainer.fit_epoch`` reads them, ``read_lag`` steps late: the steps in
between stay queued on the card, so that a stall of the host's clock does
not leave it idle. The window sends no step once its time is up, waits for
all that were sent and reads every loss: all that work over all that time.

Set-up builds the one trainer from the benchmark's seeded weights and
drives it through its first three steps on the pool's first three batches;
those steps are what the reference follows: each step's loss, the first
gradient as Adam received it (its first moment over 1 - beta1) and each
parameter's change over the three steps, compared leaf by leaf. The window
then carries on with the same trainer from the fourth batch; its own steps
are held only to finite losses. The configuration states float32 with
TF32 off: the TF32 switches as the program left them after the window are
a compared number (0 of them on), and the reference computes with every
switch off, whatever the program set.
"""

from __future__ import annotations

import gc
import math
import time
from collections import deque

import numpy as np
import torch
from torch.autograd.profiler import record_function

from portbench import inputs, spans, tracing
from portbench.harness import Check, Window
from portbench.reference import losses as ref_losses
from portbench.reference.adam import Adam
from portbench.reference.precision import Operands, exact_float32, tf32_switches

REFERENCE_STEPS = 3
BETA1 = 0.9
# A leaf whose reference gradient is below this share of the median leaf's
# moves under Adam by rounding alone; its change is not compared.
STILL_LEAF = 1e-3
# The TrainConfig fields of each EMD; the other EMD's keep their defaults.
EMD_KEYS = {"auction": ("emd_eps", "emd_iters", "emd_early_exit"),
            "sinkhorn": ("sinkhorn_blur", "sinkhorn_iters")}


def _pool(ctx):
    p, cfg = ctx.params, ctx.config
    count, b, hw, n = p["pool"], p["batch"], cfg["image_hw"], cfg["num_points"]
    imgs = inputs.images(ctx.seed, count * b, hw, ctx.device)
    pts = inputs.uniform_clouds(ctx.seed, count * b, n, ctx.device)
    return [(imgs[i * b:(i + 1) * b], pts[i * b:(i + 1) * b]) for i in range(count)]


def _train_config(ctx):
    from fenet_torch.train.config import TrainConfig

    p, cfg = ctx.params, ctx.config
    return TrainConfig(batch_size=p["batch"], num_points=cfg["num_points"],
                       backbone=cfg["backbone"], fine_width=cfg["fine_width"],
                       mid_width=cfg["mid_width"], lr=p["lr"], weight_decay=p["weight_decay"],
                       lambda_cd=p["lambda_cd"], lambda_emd=p["lambda_emd"],
                       emd_impl=p["emd_impl"], **{k: p[k] for k in EMD_KEYS[p["emd_impl"]]})


def setup(ctx) -> dict:
    from fenet_torch.models.generator import Generator
    from fenet_torch.train.trainer import Trainer

    cfg, p = ctx.config, ctx.params
    pool = _pool(ctx)
    state0 = ctx.reference.init(cfg, inputs.stream_seed(ctx.seed, inputs.WEIGHTS), ctx.device)
    with torch.device(ctx.device):
        gen = Generator(num_points=cfg["num_points"], backbone=cfg["backbone"],
                        fine_width=cfg["fine_width"], mid_width=cfg["mid_width"])
    gen.load_state_dict(state0, strict=True)  # copies: state0 stays the initial weights
    trainer = Trainer(gen, _train_config(ctx), loss_mode="schedule", device=ctx.device)
    losses, grad1 = [], None
    for k in range(REFERENCE_STEPS):
        stats = trainer.train_step(*pool[k], p["epoch"], p["lr"])
        losses.append(float(stats["total_loss"]))
        if k == 0:
            moments = trainer.optimizer.state  # empty where no step was taken
            grad1 = _norms({name: moments[param]["exp_avg"] / (1.0 - BETA1) if param in moments
                            else torch.zeros_like(param)
                            for name, param in trainer.model.named_parameters()})
    change = _norms({name: param.detach() - state0[name]
                     for name, param in trainer.model.named_parameters()})
    return {"pool": pool, "state0": state0, "trainer": trainer,
            "program": {"losses": losses, "grad1": grad1, "change": change}}


def _norms(tensors: dict) -> dict:
    names = list(tensors)
    values = torch.stack([torch.linalg.vector_norm(tensors[n].float()) for n in names]).cpu()
    return dict(zip(names, values.tolist()))


def _steps(trainer, pool, start: int, epoch: int, lr: float, lag: int, seconds=None,
           count=None):
    """Train steps over the pool from batch ``start`` on, for ``count``
    steps or until ``seconds`` have passed, each step's losses read back
    ``lag`` steps after it was sent and the rest at the end; (steps, steps
    with a loss that is not finite)."""
    done = bad = 0
    sent = deque()

    def read(stats):
        values = [float(v) for v in stats.values()]  # as fit_epoch reads them back
        return not all(math.isfinite(v) for v in values)

    t0 = time.perf_counter()
    while (count is None or done < count) and (seconds is None or done == 0
                                               or time.perf_counter() - t0 < seconds):
        with record_function("portbench.step"):
            stats = trainer.train_step(*pool[(start + done) % len(pool)], epoch, lr)
        sent.append({k: v.detach() for k, v in stats.items()})  # not their graphs
        done += 1
        if len(sent) > lag:
            bad += read(sent.popleft())
    while sent:
        bad += read(sent.popleft())
    return done, bad


def window(ctx, state) -> Window:
    p, dev = ctx.params, ctx.device
    trainer, pool = state["trainer"], state["pool"]
    tracing.sync(dev)
    opened, t0 = time.time(), time.perf_counter()
    if ctx.trace:
        from fenet_torch.losses import sinkhorn

        with spans.forward_of(trainer.model, "portbench.model"), \
                spans.around(trainer, "loss", "portbench.loss"), \
                spans.around(sinkhorn, "sinkhorn_potentials", "portbench.potentials"), \
                tracing.traced(ctx.tmp, dev) as held:
            steps, bad = _steps(trainer, pool, REFERENCE_STEPS, p["epoch"], p["lr"],
                                p["read_lag"], count=p["trace_steps"])
    else:
        steps, bad = _steps(trainer, pool, REFERENCE_STEPS, p["epoch"], p["lr"],
                            p["read_lag"], seconds=ctx.seconds)
    tracing.sync(dev)
    seconds = time.perf_counter() - t0
    return Window(opened, seconds, steps * p["batch"], steps, bad,
                  held["trace"] if ctx.trace else None, {"steps": steps})


def end_to_end(ctx, state, win: Window) -> dict:
    return {"train_samples_per_s": win.work / win.seconds}


def reference_run(ctx, state0: dict, batches, ops: Operands = Operands(), half: bool = False):
    """The reference's first steps from ``state0`` over ``batches``:
    {"losses", "grad1", "change"} as the program's. ``half`` takes each
    loss over the first half of the batch alone (a fault to read)."""
    cfg, p, dev, ref = ctx.config, ctx.params, ctx.device, ctx.reference
    names = [n for n, _, kind, _ in ref.spec(cfg) if kind in ("weight", "bias", "bn_weight",
                                                               "bn_bias")]
    params = {n: state0[n].detach().clone().requires_grad_(True) for n in names}
    adam = Adam(p["lr"], p["weight_decay"])
    losses, grad1 = [], None
    for k, (img, pts) in enumerate(batches):
        images = torch.as_tensor(img, device=dev)
        gt = torch.as_tensor(pts, device=dev, dtype=torch.float32)
        pred = ref.forward({**state0, **params}, images, cfg, True, ops)[2]
        rows = pred.shape[0] // 2 if half else pred.shape[0]
        loss, gpred = _loss_and_grad(ctx, pred.detach()[:rows], gt[:rows], ops)
        gpred = torch.cat([gpred, torch.zeros_like(pred[rows:])]) if half else gpred
        grads = dict(zip(names, torch.autograd.grad(pred, [params[n] for n in names], gpred)))
        if k == 0:
            grad1 = _norms({n: grads[n] + p["weight_decay"] * params[n].detach() for n in names})
        adam.step({n: params[n].data for n in names}, grads)
        losses.append(loss)
        del pred, gpred, grads
    change = _norms({n: params[n].detach() - state0[n] for n in names})
    return {"losses": losses, "grad1": grad1, "change": change}


def _loss_and_grad(ctx, pred: torch.Tensor, gt: torch.Tensor, ops: Operands):
    """The scheduled loss (lambda_cd CD + lambda_emd EMD up to epoch 30,
    lambda_emd EMD after) and its gradient in the prediction, a block of
    batch rows at a time."""
    p = ctx.params
    b, rows = pred.shape[0], p["reference_rows"]
    total, grad = 0.0, torch.zeros_like(pred)
    for i in range(0, b, rows):
        x = pred[i:i + rows].detach().requires_grad_(True)
        y = gt[i:i + rows]
        d1, d2 = ref_losses.chamfer(x, y, ops)
        cd = (d1.sum() / d1.shape[1] + d2.sum() / d2.shape[1]) / b
        if p["emd_impl"] == "sinkhorn":
            emd = ref_losses.sinkhorn_loss_sum(x, y, p["sinkhorn_blur"], p["sinkhorn_iters"],
                                               ops=ops) / b
        else:
            ass = ref_losses.auction(x.detach(), y, p["emd_eps"], p["emd_iters"], ops)
            emd = torch.sqrt(ref_losses.matched(x, y, ass)).mean(dim=1).sum() / b
        loss = p["lambda_emd"] * emd + (p["lambda_cd"] * cd if p["epoch"] <= 30 else 0.0)
        grad[i:i + rows] = torch.autograd.grad(loss, x)[0]
        total += float(loss.detach())
    return total, grad


def compare(ctx, got: dict, want: dict):
    """The compared numbers of ``got`` (the program's or a control's first
    steps) against the reference's ``want``."""
    out = [Check(f"loss_step{k + 1}", abs(g - w) / abs(w), ctx.limits[f"loss_step{k + 1}"])
           for k, (g, w) in enumerate(zip(got["losses"], want["losses"]))]
    ref_grad = want["grad1"]
    median = float(np.median(list(ref_grad.values())))
    moving = [n for n in ref_grad if ref_grad[n] >= STILL_LEAF * median]
    out.append(Check("grad1_leaf", _worst_leaf(got["grad1"], ref_grad, list(ref_grad)),
                     ctx.limits["grad1_leaf"]))
    out.append(Check("change3_leaf", _worst_leaf(got["change"], want["change"], moving),
                     ctx.limits["change3_leaf"]))
    return out


def _worst_leaf(got: dict, want: dict, names) -> float:
    """max over leaves of |norm(got) - norm(want)| over the larger of the
    reference leaf's norm and the median leaf's."""
    median = float(np.median([want[n] for n in names]))
    return max(abs(got[n] - want[n]) / max(want[n], median) for n in names)


def program_outputs(ctx, state) -> dict:
    """The program's first steps, its trainer freed."""
    state.pop("trainer", None)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return state["program"]


def reference_outputs(ctx, state, ops: Operands = Operands(), half: bool = False) -> dict:
    with exact_float32():
        return reference_run(ctx, state["state0"], state["pool"][:REFERENCE_STEPS], ops, half)


def check(ctx, state, win: Window):
    switches = sum(tf32_switches().values())  # as the program left them
    got = program_outputs(ctx, state)
    return [Check("tf32_switches", float(switches), ctx.limits["tf32_switches"])] + \
        compare(ctx, got, reference_outputs(ctx, state))
