"""Smoke run of the PyTorch port (fenet_torch) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``fenet_torch/csrc`` and drives
the port's eval path (RepVGG-A2 generator -> batched ICP -> auction EMD +
chamfer) at full width with seeded random weights. Each phase prints one
JSON line; any failure raises, and the script exits non-zero.

1. device: requires a CUDA card; prints nvidia-smi's name and power limit.
2. build: compiles every kernel in parallel and prints the build seconds.
3. kernels: each kernel against its plain PyTorch version at the eval shapes
   (B=64, N=M=1024): bit-exact on dyadic inputs (coordinates k/64, where
   every product and sum is exact); on random normal inputs the chamfer
   distances agree to 1e-5 and the EMD metric to 1e-2 relative (the auction
   may take another path if cuBLAS rounds the cross term differently);
   timed, and the phase's launch counts printed.
4. eval: evaluate_dataset over SyntheticShapeNet(n_models=6) at batch 64
   with ICP on; the kernels' launch counts must rise by 2 (chamfer) and 1
   (EMD) per batch. Then, as the reference, each stage of the step against
   the same stage on the CPU (the plain versions) on identical small inputs.
5. timing: each kernel, its plain version and, where one exists, a PyTorch
   library call, timed with CUDA events on the inputs the eval path gave it;
   bounds from this run's work at the H100's published peaks.

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
# Float32 operations per pair evaluation: chamfer's (aa + bb) - 2ab with a
# 3-term dot, max with 0; the auction adds a square root and two
# subtractions (3 - sqrt(d) - price).
NN_OPS_PER_PAIR = 9
EMD_OPS_PER_PAIR = 11
BATCH, N_POINTS = 64, 1024
# The untrained prediction is ~30x the gt's scale; scaling the three output
# heads brings it to the gt's, as a trained model's is.
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


def bound_ms(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


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


def make_model(device):
    import torch

    from fenet_torch.models.generator import Generator, init_random_

    with torch.device(device):
        gen = Generator(num_points=N_POINTS, backbone="RepVGG-A2", fine_width=512,
                        mid_width=128)
    init_random_(gen, torch.Generator(device=device).manual_seed(0))
    with torch.no_grad():
        for layer in (gen.fc3_1, gen.conv2_1, gen.conv1_3):
            layer.weight.mul_(HEAD_SCALE)
            layer.bias.mul_(HEAD_SCALE)
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
    emit({"phase": "eval", "model": "Generator(RepVGG-A2, num_points=1024, "
          "fine_width=512, mid_width=128)", "batch": BATCH, "batches": n_batches,
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
    profile_step(step, first)
    return launches, aligned.contiguous(), points.contiguous()


def profile_step(step, batch) -> None:
    """One eval step under torch.profiler: the device's busy time against
    the step's wall time, and the kernels that take the device time. The
    profiler's own host cost lengthens the wall time a little, so the idle
    share is an upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step(batch["image"], batch["points"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # Device-side events only: an operator's row repeats its kernels' time.
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
          "device_launches": sum(c for _, _, c in kernels),
          "top_kernels_ms": [[name[:90], ms, count] for name, ms, count in top]})


def phase_timing(launches, pred, gt):
    import torch

    from fenet_torch.ops.chamfer import _nn_ref, nn_kernel
    from fenet_torch.ops.emd import _auction_loop, auction_kernel

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
    emit({"phase": "timing", "inputs": f"eval batch 1: aligned pred vs gt, B={b}, N={n}",
          "emd_bid_rows": bids, "emd_eps": 0.005, "emd_iters": 50})
    return [nn_row, emd_row]


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
    launches, pred, gt = phase_eval(device)
    rows = phase_timing(launches, pred, gt)
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
