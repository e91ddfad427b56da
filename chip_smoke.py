"""Smoke run of the PyTorch port (fenet_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``fenet_torch/csrc`` and drives
the port's eval path (RepVGG-A2 generator -> batched ICP -> auction EMD +
chamfer) and its training step (train-mode generator -> 100·CD + 100·EMD ->
backward -> Adam) at full width with seeded random weights. Each phase
prints one JSON line; any failure raises, and the script exits non-zero.

1. device: requires a CUDA card; prints nvidia-smi's name and power limit.
2. build: compiles every kernel in parallel and prints the build seconds.
3. kernels: each kernel against its plain PyTorch version. Chamfer NN (K1)
   and the fixed-eps auction (K3) at the eval shapes (B=64, N=M=1024):
   bit-exact on dyadic inputs (coordinates k/64, where every product and
   sum is exact); on random normal inputs the chamfer distances agree to
   1e-5 and the EMD metric to 1e-2 relative. K1 over M = 16384 points (K2's
   range): bit-exact on dyadic inputs. The eps-scaling auction (K5) at
   B=64, N=1024 on dyadic inputs, gate open (on every element), gate closed
   (on every element; then also bit-identical to K3) and without the early
   exit: bit-exact. The Sinkhorn
   potentials (K6/K7) at B=128, N=M=1024 and at N=M=2048 and 8192 with a
   small batch: rtol 1e-4, atol 1e-5.
4. eval: evaluate_dataset over SyntheticShapeNet(n_models=6) at batch 64
   with ICP on; the kernels' launch counts must rise by 2 (chamfer) and 1
   (EMD) per batch. Then, as the reference, each stage of the step against
   the same stage on the CPU (the plain versions) on identical small inputs.
5. train: Trainer.train_step at batch 128 over SyntheticShapeNet(variety=
   True) in each EMD mode (auction, eps-scaling auction, Sinkhorn): one
   warm-up step, then three steps on one repeated batch with the counts set
   to 0: 2 chamfer launches and 1 EMD launch per step, finite losses, the
   total falling from step 1 to step 3; the step's ms split into forward,
   loss, backward and Adam; one step profiled; the chamfer backward twice on
   identical inputs, which must give identical bits; train_net for 2 epochs
   with validation at epoch 2, whose checkpoint must load back with
   strict=True; and one train step on the card against the same step on the
   CPU from identical weights.
   Each mode also counts the gate's open elements on every step's clouds
   (eps-scaling) and the host syncs of one step (PyTorch's sync debug mode).
6. timing: each kernel, its plain version and, where one exists, a PyTorch
   library call, timed with CUDA events on the inputs its path gave it;
   bounds from this run's work at the H100's published peaks. On the train
   step's batch-128 clouds K1 (both directions) and K5 must equal their
   plain versions bit for bit and K6 must agree to rtol 1e-4, atol 1e-5.

The line before the last is one JSON object with every kernel's numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): float32 outside the tensor
# cores and HBM3 bandwidth, at a 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Special-function results (exp2, log2, reciprocal, ...) per second: 16 per
# clock per SM at compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput table), on 132 SMs at the H100 SXM's
# 1.98 GHz boost clock. The float32 peak above is the same table's 128
# results per clock per SM.
PEAK_SFU_PER_S = 16 * 132 * 1.98e9
# Float32 operations per pair evaluation: chamfer's (aa + bb) - 2ab with a
# 3-term dot, max with 0; the auction adds a square root and two
# subtractions (3 - sqrt(d) - price).
NN_OPS_PER_PAIR = 9
EMD_OPS_PER_PAIR = 11
# Sinkhorn: a cost (9), then (pot - c) / e + log_w, the exp's argument and
# the running sum: 14 float32 operations and one exp per evaluation.
SINKHORN_OPS_PER_EVAL = 14
BATCH, N_POINTS = 64, 1024
MODEL = dict(backbone="RepVGG-A2", fine_width=512, mid_width=128)
TRAIN_BATCH = 128
TRAIN_EPOCH = 1
# Kernel checks beyond the eval shapes: K1 at K2's range (B, N, M), and the
# Sinkhorn potentials at (B, N = M, iterations).
NN_LARGE = (4, 2048, 16384)
SINKHORN_CASES = ((128, 1024, 300), (4, 2048, 300), (2, 8192, 30))
# The three EMD modes of TrainConfig and the kernel each one runs.
TRAIN_MODES = {
    "auction": ({}, "emd_auction"),
    "scaled": ({"emd_scale_phases": 3, "emd_scale_thresh": 0.3}, "emd_auction"),
    "sinkhorn": ({"emd_impl": "sinkhorn"}, "sinkhorn"),
}
# The untrained prediction is ~30x the gt's scale; scaling the three output
# heads brings it to the gt's, as a trained model's is. Training starts from
# the unscaled init, as the reference does: Adam's first steps move every
# weight by about the LR (5e-4), 25% of a scaled head weight.
HEAD_SCALE = 0.03


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, by CUDA
    events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, nbytes: float, special: float = 0.0):
    """The least time for ``ops`` float32 operations, ``special`` of them
    special-function evaluations as well, and ``nbytes`` moved."""
    t_ops = max(ops / PEAK_FP32_FLOPS, special / PEAK_SFU_PER_S)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def launch_counts():
    from fenet_torch.ops import chamfer, emd, sinkhorn

    return {"chamfer_nn": chamfer.nn_kernel.launches,
            "emd_auction": emd.auction_kernel.launches,
            "sinkhorn": sinkhorn.potentials_kernel.launches}


def reset_counts() -> None:
    from fenet_torch.ops import chamfer, emd, sinkhorn

    chamfer.nn_kernel.launches = 0
    emd.auction_kernel.launches = 0
    sinkhorn.potentials_kernel.launches = 0


def gate_open_elements(x1, x2, scale_thresh: float = 0.3) -> int:
    """Batch elements whose eps-scaling gate opens: fewer than
    ``scale_thresh·N`` distinct gt columns are some row's nearest (the
    argmax of the value at price 0), the quantity the kernel counts."""
    import torch

    from fenet_torch.ops.emd import gate_threshold
    from fenet_torch.ops.pairwise import pairwise_sqdist

    value = 3.0 - torch.sqrt(pairwise_sqdist(x1, x2))
    hit = torch.zeros(value.shape[:2], dtype=torch.int32, device=x1.device)
    hits = hit.scatter_(1, value.argmax(2), 1).sum(1)
    return int((hits.float() < gate_threshold(scale_thresh, x1.shape[1])).sum())


def host_syncs(fn) -> list:
    """Call ``fn`` with PyTorch's sync debug mode on. Returns one entry for
    each synchronising CUDA call it made (a blocking copy, a read to the
    host): the innermost line of the port on the Python stack, and the
    line that made the call. The kernels' ctypes launches do not
    synchronise."""
    import traceback
    import warnings

    import torch

    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        port = [f for f in traceback.extract_stack()
                if Path(f.filename).resolve().is_relative_to(ROOT / "fenet_torch")]
        where = (f"{Path(port[-1].filename).resolve().relative_to(ROOT)}:{port[-1].lineno}"
                 if port else "outside the port")
        syncs.append(f"{where} ({'/'.join(Path(filename).parts[-2:])}:{lineno})")

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return syncs


def clouds(kind: str, rng, device):
    import numpy as np
    import torch

    shape = (BATCH, N_POINTS, 3)
    if kind == "dyadic":
        x = rng.randint(-64, 65, size=shape) / 64.0
    else:
        x = rng.randn(*shape)
    return torch.tensor(x, dtype=torch.float32, device=device)


def phase_kernels(device) -> None:
    import numpy as np
    import torch

    from fenet_torch.ops.chamfer import _nn_ref, nn_kernel
    from fenet_torch.ops.emd import _auction_plain, auction_kernel

    nn_kernel.launches = auction_kernel.launches = 0
    rng = np.random.RandomState(0)
    for kind in ("dyadic", "normal"):
        a, b = clouds(kind, rng, device), clouds(kind, rng, device)
        d_k, i_k = nn_kernel(a, b)
        torch.cuda.synchronize()
        d_p, i_p = _nn_ref(a, b)
        err = float((d_k - d_p).abs().max())
        same = float((i_k == i_p).float().mean())
        if kind == "dyadic" and not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)):
            raise AssertionError(f"chamfer_nn differs from plain on dyadic inputs: {err}, {same}")
        if err > 1e-5:
            raise AssertionError(f"chamfer_nn max |d dist| {err} > 1e-5 on {kind} inputs")
        emit({"phase": "kernels", "kernel": "chamfer_nn", "inputs": kind,
              "max_abs_dist_err": err, "idx_equal_share": same,
              "kernel_ms": cuda_ms(lambda: nn_kernel(a, b), 50),
              "plain_ms": cuda_ms(lambda: _nn_ref(a, b), 10),
              "library_ms": cuda_ms(lambda: torch.cdist(a, b).min(-1), 10)})
        for eps, iters in ((0.005, 50), (0.05, 3000)):
            d_k, a_k = auction_kernel(a, b, eps, iters)
            torch.cuda.synchronize()
            d_p, a_p = _auction_plain(a, b, eps, iters)
            err = float((d_k - d_p).abs().max())
            same = float((a_k == a_p).float().mean())
            m_k, m_p = float(d_k.sqrt().mean()), float(d_p.sqrt().mean())
            if kind == "dyadic" and not (torch.equal(d_k, d_p) and torch.equal(a_k, a_p)):
                raise AssertionError(f"emd_auction differs from plain on dyadic inputs "
                                     f"at eps {eps}/{iters}: {err}, {same}")
            if abs(m_k - m_p) > 1e-2 * m_p:
                raise AssertionError(f"emd_auction metric {m_k} vs plain {m_p} at {eps}/{iters}")
            emit({"phase": "kernels", "kernel": "emd_auction", "inputs": kind,
                  "eps": eps, "iters": iters, "max_abs_dist_err": err,
                  "assignment_equal_share": same,
                  "kernel_ms": cuda_ms(lambda: auction_kernel(a, b, eps, iters), 10),
                  "plain_ms": cuda_ms(lambda: _auction_plain(a, b, eps, iters), 1, warmup=0)})
    emit({"phase": "kernels", "launches": {"chamfer_nn": nn_kernel.launches,
                                           "emd_auction": auction_kernel.launches}})


def phase_kernels_train(device) -> None:
    """K2's range, K5 and K6/K7 against their plain versions."""
    import numpy as np
    import torch

    from fenet_torch.ops.chamfer import _nn_ref, nn_kernel
    from fenet_torch.ops.emd import _auction_plain, auction_kernel
    from fenet_torch.ops.sinkhorn import _potentials_plain, potentials_kernel

    rng = np.random.RandomState(2)
    dyadic = lambda *shape: torch.tensor(rng.randint(-64, 65, size=shape) / 64.0,
                                         dtype=torch.float32, device=device)
    bsz, n, m = NN_LARGE
    a, b = dyadic(bsz, n, 3), dyadic(bsz, m, 3)
    d_k, i_k = nn_kernel(a, b)
    torch.cuda.synchronize()
    d_p, i_p = _nn_ref(a, b)
    if not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)):
        raise AssertionError(f"chamfer_nn differs from plain at M = {m}")
    emit({"phase": "kernels", "kernel": "chamfer_nn", "inputs": "dyadic", "B": bsz, "N": n,
          "M": m, "bit_exact": True,
          "kernel_ms": cuda_ms(lambda: nn_kernel(a, b), 20),
          "plain_ms": cuda_ms(lambda: _nn_ref(a, b), 3),
          "library_ms": cuda_ms(lambda: torch.cdist(a, b).min(-1), 3),
          "bound_ms": bound_ms(bsz * n * m * NN_OPS_PER_PAIR, (bsz * n + bsz * m) * 12
                               + bsz * n * 8)[0]})

    x1, x2 = dyadic(BATCH, N_POINTS, 3), dyadic(BATCH, N_POINTS, 3)
    clustered = torch.round(x1 * 4) / 256  # few distinct points: the gate opens
    for case, pred, early_exit in (("gate open", clustered, True),
                                   ("gate closed", x1, True),
                                   ("gate open, no early exit", clustered, False)):
        args = (pred, x2, 0.05, 3000, 3, early_exit, 0.3)
        opened = gate_open_elements(pred, x2)
        if opened != (0 if case == "gate closed" else BATCH):
            raise AssertionError(f"emd_auction ({case}): the gate opens on {opened} "
                                 f"of {BATCH} elements")
        d_k, a_k = auction_kernel(*args)
        torch.cuda.synchronize()
        d_p, a_p = _auction_plain(*args)
        if not (torch.equal(d_k, d_p) and torch.equal(a_k, a_p)):
            raise AssertionError(f"emd_auction (scaled, {case}) differs from plain")
        if case == "gate closed":
            d_f, a_f = auction_kernel(pred, x2, 0.05, 3000)
            if not (torch.equal(d_k, d_f) and torch.equal(a_k, a_f)):
                raise AssertionError("closed gate: not the fixed-eps kernel's result")
        emit({"phase": "kernels", "kernel": "emd_auction", "inputs": "dyadic",
              "mode": f"scale_phases 3, scale_thresh 0.3, {case}", "eps": 0.05,
              "iters": 3000, "bit_exact": True, "gate_open_elements": opened,
              "kernel_ms": cuda_ms(lambda: auction_kernel(*args), 5),
              "plain_ms": cuda_ms(lambda: _auction_plain(*args), 1, warmup=0)})

    for bsz, n, iters in SINKHORN_CASES:
        x = torch.rand(bsz, n, 3, device=device, generator=torch.Generator(device).manual_seed(n))
        y = torch.rand(bsz, n, 3, device=device, generator=torch.Generator(device).manual_seed(n + 1))
        f_k, g_k = potentials_kernel(x, y, 1e-4, iters, 0.25)
        torch.cuda.synchronize()
        f_p, g_p = _potentials_plain(x, y, 1e-4, iters, 0.25)
        for got, want in ((f_k, f_p), (g_k, g_p)):
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        evals = 2 * bsz * n * n * iters
        emit({"phase": "kernels", "kernel": "sinkhorn", "B": bsz, "N": n, "M": n,
              "iters": iters, "eps": 1e-4,
              "bound_ms": bound_ms(evals * SINKHORN_OPS_PER_EVAL, 2 * bsz * n * 16 + iters * 4,
                                   special=evals)[0],
              "max_abs_err": max(float((f_k - f_p).abs().max()), float((g_k - g_p).abs().max())),
              "kernel_ms": cuda_ms(lambda: potentials_kernel(x, y, 1e-4, iters, 0.25), 1),
              "plain_ms": cuda_ms(lambda: _potentials_plain(x, y, 1e-4, iters, 0.25), 1,
                                  warmup=0)})


def model_name() -> str:
    return (f"Generator({MODEL['backbone']}, num_points={N_POINTS}, "
            f"fine_width={MODEL['fine_width']}, mid_width={MODEL['mid_width']})")


def make_model(device, head_scale: float = HEAD_SCALE):
    import torch

    from fenet_torch.models.generator import Generator, init_random_

    with torch.device(device):
        gen = Generator(num_points=N_POINTS, **MODEL)
    init_random_(gen, torch.Generator(device=device).manual_seed(0))
    with torch.no_grad():
        for layer in (gen.fc3_1, gen.conv2_1, gen.conv1_3):
            layer.weight.mul_(head_scale)
            layer.bias.mul_(head_scale)
    return gen.eval()


def phase_eval(device):
    import numpy as np
    import torch

    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.eval.runner import evaluate_dataset, make_eval_step
    from fenet_torch.geometry.icp import align_pred_to_gt
    from fenet_torch.ops import chamfer, emd

    gen = make_model(device)
    ds = SyntheticShapeNet(n_models=6, num_points=N_POINTS, seed=0)
    loader = DataLoader(ds, BATCH)
    first = next(iter(loader))
    step = make_eval_step(gen, device=device)
    step(first["image"], first["points"])  # warm-up: cuDNN plans, library loads
    torch.cuda.synchronize()

    chamfer.nn_kernel.launches = 0
    emd.auction_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, _, summary = evaluate_dataset(gen, loader, category="synthetic", device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"chamfer_nn": chamfer.nn_kernel.launches,
                "emd_auction": emd.auction_kernel.launches}
    n_batches = len(loader)
    if launches != {"chamfer_nn": 2 * n_batches, "emd_auction": n_batches}:
        raise AssertionError(f"eval path launched {launches} over {n_batches} batches")
    if summary["samples"] != len(ds) or not all(
            np.isfinite(summary[k]) for k in ("EMD_distance", "ChamferDistance")):
        raise AssertionError(f"eval summary is wrong: {summary}")

    # Per-phase times on the first batch, host clock around synchronised work.
    images = torch.as_tensor(first["image"]).to(device)
    points = torch.as_tensor(first["points"]).to(device)
    phases = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        phases[name] = (time.perf_counter() - t) * 1e3
        return out

    with torch.inference_mode():
        pred = timed("generator_ms", lambda: gen(images)[2])
        aligned = timed("icp_ms", lambda: align_pred_to_gt(pred, points))
        timed("emd_ms", lambda: emd.earth_mover_distance(aligned, points))
        timed("chamfer_ms", lambda: chamfer.chamfer_distance(aligned, points))
    emit({"phase": "eval", "model": model_name(), "batch": BATCH, "batches": n_batches,
          "samples": summary["samples"], "wall_s": wall,
          "samples_per_s": summary["samples"] / wall,
          "EMD_distance": summary["EMD_distance"],
          "ChamferDistance": summary["ChamferDistance"], "launches": launches,
          "first_batch_phase_ms": phases,
          "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "pred_abs_max": float(pred.abs().max())})

    # Reference on a small input: each stage on the card against the same
    # stage on the CPU, on identical inputs. The generator differs only by
    # convolution summation order. ICP is checked on a noise-free rotated
    # copy, which it aligns exactly (a translation would not come back
    # exactly: the eval's `pred @ R - t` is the reference's formula, not the
    # inverse transform); on noisy clouds its float32 plateau
    # test may stop on another iteration when sums round differently
    # (measured 3e-4 on the aligned clouds). The metrics then run on the
    # CPU's aligned noisy clouds on both sides.
    cpu_gen = copy.deepcopy(gen).cpu()
    with torch.inference_mode():
        ref = cpu_gen(images[:2].cpu())[2]
    rel = float((pred[:2].cpu() - ref).abs().max() / ref.abs().max())
    rng = np.random.RandomState(1)
    gt = points[:2].cpu()
    ang = 0.3
    rot = torch.tensor([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                        [0, 0, 1]], dtype=torch.float32)
    moved = gt @ rot.T
    noisy = moved + torch.tensor(rng.normal(0, 0.01, gt.shape), dtype=torch.float32)
    with torch.inference_mode():
        al_card = align_pred_to_gt(moved.to(device), gt.to(device)).cpu()
        al_host = align_pred_to_gt(moved, gt)
        al = align_pred_to_gt(noisy, gt)
    card, host = {}, {}
    for out, dev in ((card, device), (host, torch.device("cpu"))):
        with torch.inference_mode():
            d, _ = emd.earth_mover_distance(al.to(dev), gt.to(dev))
            d1, d2, _, _ = chamfer.chamfer_distance(al.to(dev), gt.to(dev))
        out.update(emd=d.sqrt().mean(1).cpu() * 100,
                   cd=(d1.mean(1) + d2.mean(1)).cpu() * 100)
    checks = {
        "generator_rel_err": rel,
        "icp_aligned_max_abs_err": float((al_card - al_host).abs().max()),
        "icp_residual": float((al_card - gt).abs().max()),
        "cd_rel_err": float(((card["cd"] - host["cd"]).abs() / host["cd"]).max()),
        "emd_rel_err": float(((card["emd"] - host["emd"]).abs() / host["emd"]).max()),
    }
    limits = {"generator_rel_err": 1e-4, "icp_aligned_max_abs_err": 1e-5,
              "icp_residual": 1e-4, "cd_rel_err": 1e-5, "emd_rel_err": 1e-2}
    emit({"phase": "reference", "card_vs_cpu": checks, "limits": limits})
    for key, limit in limits.items():
        if not checks[key] <= limit:
            raise AssertionError(f"card vs CPU {key} = {checks[key]} > {limit}")
    profile_step(lambda: step(first["image"], first["points"]),
                 f"eval step (batch {BATCH})")
    return launches, aligned.contiguous(), points.contiguous()


def record_emd_inputs(trainer) -> list:
    """Make ``trainer`` record the (pred, gt) clouds of every EMD loss call,
    detached and contiguous, as its kernel takes them."""
    seen = []
    emd = trainer.emd

    def recording(pred, points):
        seen.append((pred.detach().contiguous(), points.detach().contiguous()))
        return emd(pred, points)

    trainer.emd = recording
    return seen


def split_step(trainer, images, points, lr) -> dict:
    """One train step in its parts, each timed by the host clock around
    synchronised work: what Trainer.train_step does, piece by piece."""
    import torch

    from fenet_torch.losses.facade import chamfer_loss

    ms = {}
    torch.cuda.synchronize()
    t = time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] = (now - t) * 1e3
        t = now

    images = torch.as_tensor(images).to(trainer.device)
    points = torch.as_tensor(points).to(trainer.device, torch.float32)
    trainer.model.train()
    for group in trainer.optimizer.param_groups:
        group["lr"] = lr
    trainer.optimizer.zero_grad(set_to_none=True)
    mark("input_ms")
    _, _, pred = trainer.model(images)
    mark("forward_ms")
    cd = chamfer_loss(pred, points)
    mark("chamfer_loss_ms")
    emd = trainer.emd(pred, points)
    mark("emd_loss_ms")
    total = trainer.config.lambda_cd * cd + trainer.config.lambda_emd * emd
    total.backward()
    mark("backward_ms")
    trainer.optimizer.step()
    mark("adam_ms")
    return ms


def phase_train(device) -> dict:
    """The training step in each EMD mode, the chamfer backward's
    determinism, train_net, and one step on the card against the CPU.
    Returns each mode's launch counts and the clouds its kernels saw."""
    import numpy as np
    import torch

    from fenet_torch.data.loader import DataLoader
    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.losses.facade import chamfer_loss
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer, reference_lr_schedule

    gen = make_model(device, head_scale=1.0)
    init_state = {k: v.clone() for k, v in gen.state_dict().items()}
    ds = SyntheticShapeNet(n_models=6, num_points=N_POINTS, variety=True, seed=0)
    batch = next(iter(DataLoader(ds, TRAIN_BATCH, shuffle=True, drop_last=True, seed=0)))
    images = batch["image"].astype(np.uint8)  # the reader's uint8 pixels
    points = batch["points"]
    lr = reference_lr_schedule(5e-4, TRAIN_EPOCH)
    info = {}
    for mode, (overrides, kernel) in TRAIN_MODES.items():
        gen.load_state_dict(init_state)
        trainer = Trainer(gen, TrainConfig(batch_size=TRAIN_BATCH, **overrides), device=device)
        seen = record_emd_inputs(trainer)
        trainer.train_step(images, points, TRAIN_EPOCH, lr)  # warm-up: cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses, step_ms = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            stats = trainer.train_step(images, points, TRAIN_EPOCH, lr)
            losses.append({k: float(v) for k, v in stats.items()})  # synchronises
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts()
        want = {"chamfer_nn": 6, "emd_auction": 0, "sinkhorn": 0}
        want[kernel] = 3
        if launches != want:
            raise AssertionError(f"train ({mode}) launched {launches}, not {want}")
        if not all(np.isfinite(v) for step in losses for v in step.values()):
            raise AssertionError(f"train ({mode}) losses are not finite: {losses}")
        if not losses[2]["total_loss"] < losses[0]["total_loss"]:
            raise AssertionError(f"train ({mode}) loss did not fall: {losses}")
        peak = torch.cuda.max_memory_allocated()
        split = split_step(trainer, images, points, lr)
        syncs = host_syncs(lambda: trainer.train_step(images, points, TRAIN_EPOCH, lr))
        # The clouds the EMD loss saw: the warm-up step's, then the first
        # counted step's, on which the kernels line times this mode's kernel.
        info[mode] = {"launches": launches, "pred": seen[1][0], "gt": seen[1][1],
                      "warmup_pred": seen[0][0]}
        extra = {}
        if mode == "scaled":
            extra["gate_open_elements_per_step"] = [
                gate_open_elements(pred, gt) for pred, gt in seen[:4]]
        emit({"phase": "train", "mode": mode, "config": overrides,
              "model": model_name(), "batch": TRAIN_BATCH, "launches": launches, "losses": losses,
              "step_ms": step_ms, "samples_per_s": TRAIN_BATCH * 3e3 / sum(step_ms),
              "split_step_ms": split, "max_memory_allocated_bytes": peak,
              "host_syncs_per_step": syncs, **extra})
        if mode == "auction":
            profile_step(lambda: trainer.train_step(images, points, TRAIN_EPOCH, lr),
                         f"train step ({mode}, batch {TRAIN_BATCH})")
        # The recording wrapper refers back to the trainer: drop it, or this
        # trainer and its Adam state outlive the mode.
        del trainer.emd

    # The chamfer backward is a deterministic scatter: identical bits twice.
    grads = []
    for _ in range(2):
        pred = info["auction"]["pred"].clone().requires_grad_(True)
        chamfer_loss(pred, info["auction"]["gt"]).backward()
        grads.append(pred.grad)
    if not torch.equal(grads[0], grads[1]):
        raise AssertionError("chamfer backward differs between two identical runs")
    emit({"phase": "train", "check": "chamfer backward deterministic", "identical": True,
          "grad_abs_max": float(grads[0].abs().max())})
    phase_train_net(device, gen, init_state)
    phase_train_reference(device, gen, init_state, images[:2], points[:2], lr)
    return info


def phase_train_net(device, gen, init_state) -> None:
    """train_net for 2 epochs, validating at epoch 2; its checkpoint must
    load back with strict=True."""
    import tempfile

    import torch

    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.models.generator import Generator
    from fenet_torch.train.checkpoint import BEST, load_checkpoint
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.driver import train_net

    gen.load_state_dict(init_state)
    # 24 views a model: the fewest models that fill one batch an epoch.
    train_ds = SyntheticShapeNet(n_models=-(-TRAIN_BATCH // 24), num_points=N_POINTS,
                                 variety=True, seed=0)
    val_ds = SyntheticShapeNet(n_models=1, num_points=N_POINTS, seed=1)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        cfg = TrainConfig(batch_size=TRAIN_BATCH, nepoch=2, validate_epochs=(2,),
                          train_save_freq=0, dir_path=tmp, manual_seed=0)
        reset_counts()
        t0 = time.perf_counter()
        out = train_net("synthetic", cfg, train_ds, val_ds, model=gen, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        # 2 epochs of training steps, then the validation batches: each runs
        # chamfer (2 launches) and the auction (1).
        steps = 2 * (len(train_ds) // TRAIN_BATCH) + -(-len(val_ds) // TRAIN_BATCH)
        want = {"chamfer_nn": 2 * steps, "emd_auction": steps, "sinkhorn": 0}
        if launches != want:
            raise AssertionError(f"train_net launched {launches}, not {want}")
        history = out["history"]
        if len(history) != 2 or "val" not in history[1]:
            raise AssertionError(f"train_net history is wrong: {history}")
        t1 = time.perf_counter()
        blob = load_checkpoint(str(Path(out["ckpt_dir"]) / BEST))
        with torch.device(device):
            fresh = Generator(num_points=N_POINTS, **MODEL)
        fresh.load_state_dict(blob["state_dict"], strict=True)
        if not torch.equal(fresh.fc3_1.weight, gen.fc3_1.weight) or blob["epoch"] != 2:
            raise AssertionError("the checkpoint does not hold the trained weights")
        emit({"phase": "train_net", "epochs": 2, "wall_s": wall, "launches": launches,
              "history": history, "checkpoint_load_s": time.perf_counter() - t1,
              "checkpoint_bytes": (Path(out["ckpt_dir"]) / BEST).stat().st_size,
              "loads_strict": True})


def phase_train_reference(device, gen, init_state, images, points, lr) -> None:
    """One train step (default mode) on the card against the same step on
    the CPU, from identical weights, at full width on a batch of 2."""
    import copy

    import torch

    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer

    gen.load_state_dict(init_state)
    cpu_gen = copy.deepcopy(gen).cpu()
    cfg = TrainConfig(batch_size=len(images))
    card = Trainer(gen, cfg, device=device).train_step(images, points, TRAIN_EPOCH, lr)
    t0 = time.perf_counter()
    host = Trainer(cpu_gen, cfg, device="cpu").train_step(images, points, TRAIN_EPOCH, lr)
    cpu_s = time.perf_counter() - t0
    g_card, g_host = gen.fc3_1.weight.grad.cpu(), cpu_gen.fc3_1.weight.grad
    checks = {
        "cd_rel_err": abs(float(card["chamfer_loss"]) - float(host["chamfer_loss"]))
        / float(host["chamfer_loss"]),
        "emd_rel_err": abs(float(card["emd_loss"]) - float(host["emd_loss"]))
        / float(host["emd_loss"]),
        "fc3_1_grad_rel_err": float((g_card - g_host).norm() / g_host.norm()),
    }
    # CD as in eval. EMD as in eval: the auction may resolve a near-tie the
    # other way on predictions that differ by ~1e-6. The gradient of fc3_1
    # (relative L2) carries that: a few flipped rows of 2048 move it ~1e-3.
    limits = {"cd_rel_err": 1e-5, "emd_rel_err": 1e-2, "fc3_1_grad_rel_err": 1e-2}
    emit({"phase": "reference", "path": "train step, batch 2", "card_vs_cpu": checks,
          "limits": limits, "cpu_step_s": cpu_s})
    for key, limit in limits.items():
        if not checks[key] <= limit:
            raise AssertionError(f"train step card vs CPU {key} = {checks[key]} > {limit}")


def profile_step(step, path: str) -> None:
    """One call of ``step`` under torch.profiler: the device's busy time
    against the call's wall time, and the kernels that take the device time.
    The profiler's own host cost lengthens the wall time a little, so the
    idle share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # Device-side events only: an operator's row repeats its kernels' time.
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit({"phase": "profile", "path": path, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
          "device_launches": sum(c for _, _, c in kernels),
          "top_kernels_ms": [[name[:90], ms, count] for name, ms, count in top]})


def phase_timing(launches, pred, gt, train):
    """The kernels line. K1 and K3 on the eval path's inputs (the first eval
    batch: aligned predictions vs gt) at the eval settings; K5 and K6/K7 on
    the inputs the training step gave them, with their launches in that
    mode's three steps. Each kernel is also held against its plain version
    on the train step's batch-128 clouds: K1 and K5 bit for bit, K6 to
    rtol 1e-4 / atol 1e-5."""
    import torch

    from fenet_torch.ops.chamfer import _nn_ref, nn_kernel
    from fenet_torch.ops.emd import _auction_loop, auction_kernel
    from fenet_torch.ops.sinkhorn import _potentials_plain, potentials_kernel

    b, n, m = pred.shape[0], pred.shape[1], gt.shape[1]
    d_k, _ = nn_kernel(pred, gt)
    d_p, _ = _nn_ref(pred, gt)
    nn_bound, nn_by = bound_ms(b * n * m * NN_OPS_PER_PAIR, (b * n + b * m) * 12 + b * n * 8)
    nn_row = {
        "name": "chamfer_nn", "route": "cuda", "source": "fenet_torch/csrc/chamfer_nn.cu",
        "replaces": "fenet/ops/chamfer.py:75", "launches": launches["chamfer_nn"],
        "max_abs_err": float((d_k - d_p).abs().max()),
        "ms": cuda_ms(lambda: nn_kernel(pred, gt), 100, warmup=5),
        "plain_ms": cuda_ms(lambda: _nn_ref(pred, gt), 20),
        "bound_ms": nn_bound, "bound_by": nn_by,
        "library_ms": cuda_ms(lambda: torch.cdist(pred, gt).min(-1), 20),
    }
    d_k, _ = auction_kernel(pred, gt, 0.005, 50)
    d_p, _, bid_rows = _auction_loop(pred, gt, 0.005, 50)
    bids = int(bid_rows.sum())
    emd_bound, emd_by = bound_ms(bids * n * EMD_OPS_PER_PAIR, b * n * 12 * 2 + b * n * 8)
    emd_row = {
        "name": "emd_auction", "route": "cuda", "source": "fenet_torch/csrc/emd_auction.cu",
        "replaces": "fenet/ops/emd.py:200", "launches": launches["emd_auction"],
        "max_abs_err": float((d_k - d_p).abs().max()),
        "ms": cuda_ms(lambda: auction_kernel(pred, gt, 0.005, 50), 50, warmup=5),
        "plain_ms": cuda_ms(lambda: _auction_loop(pred, gt, 0.005, 50), 5),
        "bound_ms": emd_bound, "bound_by": emd_by, "library_ms": None,
    }

    # K1 on the train step's clouds (batch 128), both directions, against
    # its plain version bit for bit: the step's own launches.
    x1, x2 = train["auction"]["pred"], train["auction"]["gt"]
    for a, c in ((x1, x2), (x2, x1)):
        d_k, i_k = nn_kernel(a, c)
        d_p, i_p = _nn_ref(a, c)
        if not (torch.equal(d_k, d_p) and torch.equal(i_k, i_p)):
            raise AssertionError(
                f"chamfer_nn differs from plain on the train clouds (B={a.shape[0]}): "
                f"{float((d_k - d_p).abs().max())}, {float((i_k != i_p).float().mean())}")

    # K5: the training auction with eps-scaling and the gate, on the clouds
    # of the mode's first counted step, and on the warm-up step's.
    x1, x2 = train["scaled"]["pred"], train["scaled"]["gt"]
    b, n = x1.shape[0], x1.shape[1]

    def scaled_auction(x1):
        args = (x1, x2, 0.05, 3000, 3, True, 0.3)
        d_k, a_k = auction_kernel(*args)
        t0 = time.perf_counter()
        d_p, a_p, bid_rows = _auction_loop(*args)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not (torch.equal(d_k, d_p) and torch.equal(a_k, a_p)):
            raise AssertionError(
                f"emd_auction (scaled) differs from plain on the train clouds (B={b}): "
                f"{float((d_k - d_p).abs().max())}, {float((a_k != a_p).float().mean())}")
        bids = int(bid_rows.sum())
        bound = bound_ms((bids * n + b * n * n) * EMD_OPS_PER_PAIR, b * n * 12 * 2 + b * n * 8)
        return {"gate_open_elements": gate_open_elements(x1, x2), "bid_rows": bids,
                "max_abs_err": float((d_k - d_p).abs().max()),
                "ms": cuda_ms(lambda: auction_kernel(*args), 10, warmup=2),
                "plain_ms": plain_ms, "bound": bound}

    step1 = scaled_auction(x1)
    warmup = scaled_auction(train["scaled"]["warmup_pred"])
    k5_bound, k5_by = step1.pop("bound")
    warmup["bound_ms"] = warmup.pop("bound")[0]
    k5_row = {
        "name": "emd_auction_scaled", "route": "cuda",
        "source": "fenet_torch/csrc/emd_auction.cu",
        "replaces": "fenet/ops/emd.py:200 (scale_phases > 1, :262-281, :401-419)",
        "launches": train["scaled"]["launches"]["emd_auction"],
        "max_abs_err": step1["max_abs_err"], "ms": step1["ms"], "plain_ms": step1["plain_ms"],
        "bound_ms": k5_bound, "bound_by": k5_by, "library_ms": None,
    }

    # K6/K7: the Sinkhorn loss's potentials, eps = blur² = 1e-4, 300 iters,
    # held to fenet's tolerance on the train step's clouds.
    x, y = train["sinkhorn"]["pred"], train["sinkhorn"]["gt"]
    b, n, m = x.shape[0], x.shape[1], y.shape[1]
    iters = 300
    f_k, g_k = potentials_kernel(x, y, 1e-4, iters, 0.25)
    f_p, g_p = _potentials_plain(x, y, 1e-4, iters, 0.25)
    for got, want in ((f_k, f_p), (g_k, g_p)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    evals = 2 * b * n * m * iters
    k6_bound, k6_by = bound_ms(evals * SINKHORN_OPS_PER_EVAL, (b * n + b * m) * 16 + iters * 4,
                               special=evals)
    k6_row = {
        "name": "sinkhorn", "route": "cuda", "source": "fenet_torch/csrc/sinkhorn.cu",
        "replaces": "fenet/ops/sinkhorn.py:43 and :114",
        "launches": train["sinkhorn"]["launches"]["sinkhorn"],
        "max_abs_err": max(float((f_k - f_p).abs().max()), float((g_k - g_p).abs().max())),
        "ms": cuda_ms(lambda: potentials_kernel(x, y, 1e-4, iters, 0.25), 5, warmup=1),
        "plain_ms": cuda_ms(lambda: _potentials_plain(x, y, 1e-4, iters, 0.25), 1, warmup=0),
        "bound_ms": k6_bound, "bound_by": k6_by, "library_ms": None,
    }
    emit({"phase": "timing", "inputs": f"eval batch 1: aligned pred vs gt, B={pred.shape[0]}, "
          f"N={pred.shape[1]}; train: the batch-{TRAIN_BATCH} clouds of each mode's first "
          f"counted step (K5 also on its warm-up step's)",
          "emd_bid_rows": bids, "emd_eps": 0.005, "emd_iters": 50,
          "chamfer_nn_train_clouds_bit_exact": True,
          "scaled_step1": step1, "scaled_warmup": warmup,
          "sinkhorn_evaluations": evals})
    return [nn_row, emd_row, k5_row, k6_row]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card",
              file=sys.stderr)
        return 1
    import fenet_torch

    if Path(fenet_torch.__file__).resolve().parent.parent != ROOT:
        raise RuntimeError(f"fenet_torch imported from {fenet_torch.__file__}, "
                           f"not from this checkout ({ROOT})")
    from fenet_torch.ops import _build

    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    reports = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": {
        name: [ln.strip() for ln in rep.splitlines() if "Used" in ln or "spill" in ln]
        for name, rep in reports.items()}})

    phase_kernels(device)
    phase_kernels_train(device)
    launches, pred, gt = phase_eval(device)
    train = phase_train(device)
    rows = phase_timing(launches, pred, gt, train)
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
