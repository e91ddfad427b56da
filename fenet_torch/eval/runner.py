"""Batched evaluation: forward -> ICP align -> CD/EMD metrics (counterpart
of ``fenet/eval/runner.py``), on one device or on each rank of a
multi-process run, which evaluates its shard of the dataset
(:class:`fenet_torch.parallel.ProcessShardDataset`) and sums with the
others.
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
from fenet_torch.parallel.distributed import world_size
from fenet_torch.parallel.mesh import all_gather
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

    On several processes each rank evaluates the shard its loader reads;
    the shard's wrap-around duplicates (``wrap_duplicates``, at its end)
    run through the step but stay out of the sums, and the ranks' (EMD, CD,
    count) sums are gathered. Every rank returns the same summary.
    """
    step = make_eval_step(model, device=device, **step_kwargs)
    shard = getattr(dataloader, "dataset", None)
    limit = len(shard) - int(getattr(shard, "wrap_duplicates", 0)) if shard is not None else None
    emd_sum = cd_sum = 0.0
    n_samples = seen = 0
    t0 = time.time()
    for i, batch in enumerate(dataloader, start=1):
        out = step(batch["image"], batch["points"])
        emd = out["emd"].cpu().numpy()
        cd = out["cd"].cpu().numpy()
        take = len(emd) if limit is None else min(len(emd), max(limit - seen, 0))
        seen += len(emd)
        emd_sum += float(emd[:take].sum())
        cd_sum += float(cd[:take].sum())
        n_samples += take
        if logger is not None:
            logger.info("Test[%d/%d] Taxonomy = %s Metrics = %s", i,
                        len(dataloader), category,
                        ["%.4f" % m for m in (emd.mean(), cd.mean())])
    wall = time.time() - t0
    if world_size() > 1:
        sums = torch.tensor([emd_sum, cd_sum, float(n_samples)], dtype=torch.float64)
        total = torch.stack(all_gather(sums)).sum(dim=0)
        emd_sum, cd_sum, n_samples = float(total[0]), float(total[1]), int(round(float(total[2])))
    avg = [emd_sum / max(n_samples, 1), cd_sum / max(n_samples, 1)]
    summary = {
        "EMD_distance": avg[0],
        "ChamferDistance": avg[1],
        "samples": n_samples,
        "wall_seconds": wall,
        "samples_per_second": n_samples / wall if wall > 0 else 0.0,
    }
    return Metrics("ChamferDistance", avg), Metrics("EMD_distance", avg), summary
