"""Batched evaluation on one device: forward -> ICP align -> CD/EMD metrics
(counterpart of ``fenet/eval/runner.py``; the multi-device mesh is a later
slice).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from fenet_torch.eval.metrics import EVAL_EMD_EPS, EVAL_EMD_ITERS, Metrics
from fenet_torch.geometry.icp import align_pred_to_gt
from fenet_torch.ops.chamfer import chamfer_distance
from fenet_torch.ops.emd import earth_mover_distance
from fenet_torch.utils.device import full_fp32, resolve_device


def make_eval_step(
    model: nn.Module,
    device="cuda",
    icp_iterations: int = 1024,
    icp_tolerance: float = 1e-10,
    icp_rel_tolerance: float = 1e-6,
    icp_patience: int = 32,
    icp_coarse_points: int = 0,
    icp_coarse_iterations: int = 512,
    emd_eps: float = EVAL_EMD_EPS,
    emd_iters: int = EVAL_EMD_ITERS,
    align: bool = True,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``step(images, points) -> per-sample metrics`` on ``device``.

    ``images`` (B,128,128,3) uint8 or float and ``points`` (B,N,3), numpy
    arrays or tensors. Outputs: dict of (B,) tensors, 'emd' (sqrt-mean x100)
    and 'cd' (x100), plus the aligned predictions 'pred' (B,N,3). The model
    is moved to ``device`` and put in eval mode.
    """
    device = resolve_device(device)
    full_fp32()
    model.to(device).eval()

    @torch.inference_mode()
    def step(images, points) -> Dict[str, torch.Tensor]:
        images = torch.as_tensor(images).to(device)
        points = torch.as_tensor(points).to(device, torch.float32)
        _, _, pred = model(images)
        if align:
            aligned = align_pred_to_gt(
                pred, points, max_iterations=icp_iterations,
                tolerance=icp_tolerance, rel_tolerance=icp_rel_tolerance,
                stall_patience=icp_patience, coarse_points=icp_coarse_points,
                coarse_iterations=icp_coarse_iterations,
            )
        else:
            aligned = pred
        emd_sq, _ = earth_mover_distance(aligned, points, emd_eps, emd_iters)
        d1, d2, _, _ = chamfer_distance(aligned, points)
        return {
            "emd": torch.sqrt(emd_sq).mean(dim=1) * 100.0,
            "cd": (d1.mean(dim=1) + d2.mean(dim=1)) * 100.0,
            "pred": aligned,
        }

    return step


def evaluate_dataset(
    model: nn.Module,
    dataloader,
    category: str = "",
    logger=None,
    device="cuda",
    **step_kwargs,
) -> Tuple[Metrics, Metrics, Dict[str, float]]:
    """Full-dataset eval; returns (chamfer Metrics, emd Metrics, summary).

    Both Metrics carry the same [EMD, CD] averages, named for best-checkpoint
    comparison, as in the reference's test loop.
    """
    step = make_eval_step(model, device=device, **step_kwargs)
    emd_sum = cd_sum = 0.0
    n_samples = 0
    t0 = time.time()
    for i, batch in enumerate(dataloader, start=1):
        out = step(batch["image"], batch["points"])
        emd = out["emd"].cpu().numpy()
        cd = out["cd"].cpu().numpy()
        emd_sum += float(emd.sum())
        cd_sum += float(cd.sum())
        n_samples += emd.shape[0]
        if logger is not None:
            logger.info("Test[%d/%d] Taxonomy = %s Metrics = %s", i,
                        len(dataloader), category,
                        ["%.4f" % m for m in (emd.mean(), cd.mean())])
    wall = time.time() - t0
    avg = [emd_sum / max(n_samples, 1), cd_sum / max(n_samples, 1)]
    summary = {
        "EMD_distance": avg[0],
        "ChamferDistance": avg[1],
        "samples": n_samples,
        "wall_seconds": wall,
        "samples_per_second": n_samples / wall if wall > 0 else 0.0,
    }
    return Metrics("ChamferDistance", avg), Metrics("EMD_distance", avg), summary
