"""The training step on one device (counterpart of ``fenet/train/trainer.py``,
``schedule`` loss mode).

Reference semantics kept:
- ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay)``, L2
  decay added to the gradient before the moments (not AdamW), which is
  fenet's ``add_decayed_weights`` -> ``scale_by_adam``;
- the loss schedule: 100·CD + 100·EMD for epochs 1-30, 100·EMD after; CD
  is always computed, for the log;
- the cumulative stepwise LR decay of :func:`reference_lr_schedule`, set on
  the optimizer's param groups at every step;
- train-mode BatchNorm with fenet's running-statistics update.

The EMD term is the auction (fixed eps, or eps-scaling phases with the
adaptive gate) or, with ``emd_impl="sinkhorn"``, the Sinkhorn loss. Options
of later slices raise: ``loss_mode="finetune"`` and multi-device runs.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch
from torch import nn

from fenet_torch.losses.facade import chamfer_loss, emd_loss
from fenet_torch.losses.sinkhorn import sinkhorn_emd_loss
from fenet_torch.train.config import TrainConfig
from fenet_torch.utils.average_meter import AverageMeter
from fenet_torch.utils.device import full_fp32, resolve_device


def reference_lr_schedule(base_lr: float, epoch: int) -> float:
    """LR in effect during ``epoch`` (1-indexed), the reference's cumulative
    in-place decay at each 10-epoch boundary: x0.1 below 30, x0.01 at
    [30, 40), x0.001 from 40."""
    lr = base_lr
    for boundary in range(10, epoch, 10):
        if boundary < 30:
            lr *= 0.1
        elif boundary < 40:
            lr *= 0.01
        else:
            lr *= 0.001
    return lr


def make_optimizer(model: nn.Module, config: TrainConfig) -> torch.optim.Adam:
    """The reference's optimizer; the LR is set per step by the trainer."""
    return torch.optim.Adam(model.parameters(), lr=config.lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=config.weight_decay)


class Trainer:
    """Owns the model on its device and its optimizer.

    ``train_step(images, points, epoch, lr)`` runs one step and returns its
    losses as 0-dim tensors on the device; ``fit_epoch`` runs an epoch over
    a DataLoader with the reference's per-batch log line.
    """

    def __init__(self, model: nn.Module, config: TrainConfig,
                 loss_mode: str = "schedule", device="cuda"):
        if loss_mode != "schedule":
            raise NotImplementedError(
                f"loss_mode={loss_mode!r} is not ported to fenet_torch yet "
                "(only 'schedule')")
        if config.data_parallel > 1 or config.model_parallel > 1:
            raise NotImplementedError(
                "fenet_torch trains on one device so far: data_parallel and "
                f"model_parallel must be 1, got {config.data_parallel} and "
                f"{config.model_parallel}")
        if config.emd_impl not in ("auction", "sinkhorn"):
            raise ValueError(f"emd_impl must be 'auction' or 'sinkhorn', got {config.emd_impl!r}")
        self.config = config
        self.device = resolve_device(device)
        full_fp32()
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(self.model, config)

    def emd(self, pred: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        """The configured EMD loss term (auction or Sinkhorn)."""
        cfg = self.config
        if cfg.emd_impl == "sinkhorn":
            return sinkhorn_emd_loss(pred, points, cfg.sinkhorn_blur, cfg.sinkhorn_iters)
        return emd_loss(pred, points, cfg.emd_eps, cfg.emd_iters, cfg.emd_scale_phases,
                        cfg.emd_early_exit, cfg.emd_scale_thresh)

    def loss(self, pred: torch.Tensor, points: torch.Tensor, epoch: int
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The scheduled total and its parts, for a prediction (B, N, 3)."""
        cfg = self.config
        cd = chamfer_loss(pred, points)
        emd = self.emd(pred, points)
        if epoch > 30:
            total = cfg.lambda_emd * emd
        else:
            total = cfg.lambda_cd * cd + cfg.lambda_emd * emd
        return total, {"total_loss": total.detach(), "chamfer_loss": cd.detach(),
                       "emd_loss": emd.detach()}

    def train_step(self, images, points, epoch: int, lr: float) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch: images (B, 128, 128, 3) uint8 or
        float with raw 0..255 values, points (B, N, 3); numpy or tensors.
        The images are cast to float32 on the device."""
        images = torch.as_tensor(images).to(self.device)
        points = torch.as_tensor(points).to(self.device, torch.float32)
        self.model.train()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        _, _, pred = self.model(images)
        total, stats = self.loss(pred, points, epoch)
        total.backward()
        self.optimizer.step()
        return stats

    def fit_epoch(self, dataloader, epoch: int, logger=None, metric_writer=None,
                  category: str = "") -> Dict[str, float]:
        """One epoch over a DataLoader, with the reference's per-batch log
        line; returns the epoch's mean CD and EMD losses, x100."""
        batch_time = AverageMeter()
        data_time = AverageMeter()
        losses = AverageMeter(["chamfer_loss", "emd_loss"])
        lr = reference_lr_schedule(self.config.lr, epoch)
        n_batches = len(dataloader)
        end = time.time()
        for i, batch in enumerate(dataloader, start=1):
            data_time.update(time.time() - end)
            stats = self.train_step(batch["image"], batch["points"], epoch, lr)
            values = {k: float(v) for k, v in stats.items()}
            losses.update([values["chamfer_loss"] * 100, values["emd_loss"] * 100])
            if metric_writer is not None:
                step = (epoch - 1) * n_batches + i
                for key in ("total_loss", "chamfer_loss", "emd_loss"):
                    metric_writer.add_scalar(f"scalar/{key}", values[key], step)
            batch_time.update(time.time() - end)
            end = time.time()
            if logger is not None:
                logger.info(
                    "[Category %s] [Epoch %d/%d][Batch %d/%d] BatchTime = "
                    "%.3f (s) DataTime = %.3f (s) Losses = %s",
                    category, epoch, self.config.nepoch, i, n_batches,
                    batch_time.val(), data_time.val(),
                    ["%.4f" % v for v in losses.val()],
                )
        return {"chamfer_loss": losses.avg(0), "emd_loss": losses.avg(1)}
