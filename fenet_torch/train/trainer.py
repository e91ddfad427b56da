"""The training step (counterpart of ``fenet/train/trainer.py``) in its two
loss modes, ``schedule`` (train) and ``finetune``, on one device or on each
rank of a data-parallel process mesh.

Reference semantics kept:
- ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay)``, L2
  decay added to the gradient before the moments (not AdamW), which is
  fenet's ``add_decayed_weights`` -> ``scale_by_adam``; on the card its
  step is one hand-written pass (:class:`fenet_torch.ops.adam.Adam`, a
  ``torch.optim.Adam`` with torch's state);
- the loss schedule: 100·CD + 100·EMD for epochs 1-30, 100·EMD after; CD
  is always computed, for the log;
- the cumulative stepwise LR decay of :func:`reference_lr_schedule`, set on
  the optimizer's param groups at every step;
- train-mode BatchNorm with fenet's running-statistics update.

``loss_mode="finetune"`` is the reference's finetune objective,
lambda_bce·BCE + lambda_cd·CD + lambda_emd·EMD with no epoch schedule: the
``bce_prob`` loss between the predicted and GT silhouettes of
``project_silhouettes`` at az = el = 0, differentiable through the
prediction as in fenet.

The EMD term is the auction (fixed eps, or eps-scaling phases with the
adaptive gate) or, with ``emd_impl="sinkhorn"``, the Sinkhorn loss.

On a mesh of ranks (:mod:`fenet_torch.parallel`) each rank runs the
forward, loss and backward of its shard of the batch; then the gradients,
the three losses and the BatchNorm running statistics are averaged over the
mesh before Adam, as fenet's ``pmean``s do (the statistics even with
``sync_bn`` off). With ``sync_bn`` (the default) the BatchNorms normalize
with the global batch's statistics, the single-device batch-128 semantics
at any width. Every rank holds the whole model. There is no DDP
``broadcast_buffers``: it would copy rank 0's statistics and break
``sync_bn`` off.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import torch
from torch import nn

from fenet_torch.geometry.projection import project_silhouettes
from fenet_torch.losses.facade import chamfer_loss, emd_loss
from fenet_torch.losses.projection import get_loss_proj
from fenet_torch.losses.sinkhorn import sinkhorn_emd_loss
from fenet_torch.models.repvgg import BatchNorm2d
from fenet_torch.ops.adam import Adam
from fenet_torch.parallel.mesh import Mesh, make_mesh, pmean_
from fenet_torch.train.config import TrainConfig
from fenet_torch.utils.average_meter import AverageMeter
from fenet_torch.utils.device import full_fp32, resolve_device
from fenet_torch.utils.profiling import span


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


def make_optimizer(model: nn.Module, config: TrainConfig) -> Adam:
    """The reference's optimizer; the LR is set per step by the trainer."""
    return Adam(model.parameters(), lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
                weight_decay=config.weight_decay)


class Trainer:
    """Owns the model on its device and its optimizer.

    ``train_step(images, points, epoch, lr)`` runs one step and returns its
    losses as 0-dim tensors on the device; ``fit_epoch`` runs an epoch over
    a DataLoader with the reference's per-batch log line.

    ``mesh`` (default: :func:`fenet_torch.parallel.mesh.make_mesh` of the
    config's ``data_parallel``) places this process on the ranks' mesh;
    every rank must start from the same weights.
    """

    def __init__(self, model: nn.Module, config: TrainConfig,
                 loss_mode: str = "schedule", device="cuda", mesh: Mesh | None = None):
        if loss_mode not in ("schedule", "finetune"):
            raise ValueError(f"loss_mode must be 'schedule' or 'finetune', got {loss_mode!r}")
        if config.emd_impl not in ("auction", "sinkhorn"):
            raise ValueError(f"emd_impl must be 'auction' or 'sinkhorn', got {config.emd_impl!r}")
        self.mesh = mesh if mesh is not None else make_mesh(config.data_parallel)
        self.config = config
        self.loss_mode = loss_mode
        self.device = resolve_device(device)
        full_fp32()
        self.model = model.to(self.device)
        sync = self.mesh.group if config.sync_bn else None
        for m in self.model.modules():
            if isinstance(m, BatchNorm2d):
                m.group = sync
        self.optimizer = make_optimizer(self.model, config)

    def emd(self, pred: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        """The configured EMD loss term (auction or Sinkhorn)."""
        cfg = self.config
        if cfg.emd_impl == "sinkhorn":
            return sinkhorn_emd_loss(pred, points, cfg.sinkhorn_blur, cfg.sinkhorn_iters)
        return emd_loss(pred, points, cfg.emd_eps, cfg.emd_iters, cfg.emd_scale_phases,
                        cfg.emd_early_exit, cfg.emd_scale_thresh)

    def bce(self, pred: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
        """The finetune loss's silhouette term: ``bce_prob`` between the
        projections of the prediction and of the GT."""
        cfg = self.config
        proj_pred, proj_gt = project_silhouettes(pred, points, cfg.grid_h, cfg.grid_w,
                                                 cfg.sigma_sq, squash=cfg.proj_squash)
        return get_loss_proj(proj_pred, proj_gt, "bce_prob")[0]

    def loss(self, pred: torch.Tensor, points: torch.Tensor, epoch: int
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss mode's total and its parts, for a prediction (B, N, 3)."""
        cfg = self.config
        with span("fenet_torch.loss.chamfer"):
            cd = chamfer_loss(pred, points)
        with span("fenet_torch.loss.emd"):
            emd = self.emd(pred, points)
        if self.loss_mode == "finetune":
            with span("fenet_torch.loss.bce"):
                bce = self.bce(pred, points)
            total = cfg.lambda_bce * bce + cfg.lambda_cd * cd + cfg.lambda_emd * emd
        elif epoch > 30:
            total = cfg.lambda_emd * emd
        else:
            total = cfg.lambda_cd * cd + cfg.lambda_emd * emd
        return total, {"total_loss": total.detach(), "chamfer_loss": cd.detach(),
                       "emd_loss": emd.detach()}

    def train_step(self, images, points, epoch: int, lr: float) -> Dict[str, torch.Tensor]:
        """One optimizer step on a batch: images (B, 128, 128, 3) uint8 or
        float with raw 0..255 values, points (B, N, 3); numpy or tensors.
        The images are cast to float32 on the device.

        Under a profiler each phase is a span (``fenet_torch.train.*``), on
        this thread; autograd's engine launches the backward's kernels from
        its own threads, so ``fenet_torch.train.backward`` holds this
        thread's wait for them."""
        with span("fenet_torch.train.step"):
            with span("fenet_torch.train.inputs"):
                images = torch.as_tensor(images).to(self.device)
                points = torch.as_tensor(points).to(self.device, torch.float32)
            self.model.train()
            with span("fenet_torch.train.optimizer"):
                for group in self.optimizer.param_groups:
                    group["lr"] = lr
                self.optimizer.zero_grad(set_to_none=True)
            with span("fenet_torch.train.forward"):
                _, _, pred = self.model(images)
            with span("fenet_torch.train.loss"):
                total, stats = self.loss(pred, points, epoch)
            with span("fenet_torch.train.backward"):
                total.backward()
            self.all_reduce_(stats)
            with span("fenet_torch.train.optimizer"):
                self.optimizer.step()
        return stats

    def all_reduce_(self, stats: Dict[str, torch.Tensor]) -> None:
        """Average the step's gradients, its losses (``stats``, in place)
        and the BatchNorm running statistics over the mesh, in one
        all-reduce. Nothing on one process."""
        group = self.mesh.group
        if group is None:
            return
        pmean_([param.grad for param in self.model.parameters()] + list(stats.values())
               + [buf for name, buf in self.model.named_buffers()
                  if name.endswith(("running_mean", "running_var"))], group)

    def full_state(self) -> Tuple[Dict[str, torch.Tensor], Dict]:
        """(model state_dict, optimizer state_dict): what a checkpoint
        stores."""
        return self.model.state_dict(), self.optimizer.state_dict()

    def load_full_state(self, state_dict: Dict[str, torch.Tensor], optimizer: Dict) -> None:
        """Load a checkpoint's tensors; the model loads with ``strict=True``."""
        self.model.load_state_dict(state_dict, strict=True)
        # A hyperparameter the checkpoint's groups lack keeps this optimizer's
        # value (fenet's flax container stores none: its groups hold only
        # their params).
        own = self.optimizer.state_dict()["param_groups"]
        self.optimizer.load_state_dict({**optimizer, "param_groups": [
            {**group, **saved} for group, saved in zip(own, optimizer["param_groups"])]})

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
