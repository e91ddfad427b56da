"""End-to-end per-category training on one device (counterpart of
``fenet/train/driver.py``): seeded init, a shuffled DataLoader, resume from
the newest checkpoint, periodic saves, and validation with a best copy.
"""

from __future__ import annotations

import json
import math
import os
import random
import time
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from fenet_torch.data.loader import DataLoader
from fenet_torch.data.shapenet import ShapeNetDataset, load_split
from fenet_torch.eval.metrics import Metrics
from fenet_torch.eval.runner import evaluate_dataset
from fenet_torch.models.generator import Generator, init_random_
from fenet_torch.train.checkpoint import (
    BEST,
    SUFFIX,
    check_format,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from fenet_torch.train.config import TrainConfig
from fenet_torch.train.trainer import Trainer
from fenet_torch.utils.device import resolve_device
from fenet_torch.utils.logger import get_logger


class MetricWriter:
    """Scalar logger: tensorboardX when available, else a JSONL file."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from tensorboardX import SummaryWriter

            self._tb = SummaryWriter(log_dir)
        except ImportError:
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int):
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": value, "step": step}) + "\n")
            # A crash must not lose the scalar history.
            self._jsonl.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()


def _build_datasets(cfg: TrainConfig, category):
    train_models = load_split(cfg.splits_path, "train_models.json")
    val_models = load_split(cfg.splits_path, "val_models.json")
    cats = [category] if isinstance(category, str) else list(category)
    train_ds = ShapeNetDataset(cfg.data_dir_imgs, cfg.data_dir_pcl, train_models, cats,
                               cfg.num_points, variety=True, image_dtype="uint8")
    val_ds = ShapeNetDataset(cfg.data_dir_imgs, cfg.data_dir_pcl, val_models, cats,
                             cfg.num_points, image_dtype="uint8")
    return train_ds, val_ds


def load_pretrained_backbone(model: Generator, path: str) -> None:
    """Overlay a reference RepVGG backbone checkpoint (bare or under
    ``state_dict``) on ``model.RepVGG``; keys the model lacks are skipped."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    loaded = blob.get("state_dict", blob)
    own = model.RepVGG.state_dict()
    for name, value in loaded.items():
        if name in own:
            own[name] = value
    model.RepVGG.load_state_dict(own, strict=True)


def _newest_checkpoint(ckpt_dir: str, cat: str, logger):
    """The highest-epoch checkpoint: a periodic save after the last
    validation must win over an older model_best."""
    best_path = os.path.join(ckpt_dir, BEST)
    blob = load_checkpoint(best_path) if os.path.exists(best_path) else None
    periodic = latest_checkpoint(ckpt_dir, cat, SUFFIX)
    if periodic is not None:
        epoch = int(periodic[: -len(SUFFIX)].rsplit("_", 1)[1])
        if blob is None or epoch > int(blob.get("epoch", 0)):
            logger.info("resume: periodic checkpoint %s (epoch %d) is newest", periodic, epoch)
            blob = load_checkpoint(periodic)
    if blob is None:
        raise FileNotFoundError(f"--resume: no checkpoint under {ckpt_dir}")
    return blob


def _restored_best(blob, key: str, name: str) -> Optional[Metrics]:
    """A checkpoint's running-best metric, or None (absent or NaN: no
    validation yet)."""
    value = blob.get(key)
    if value is None or not math.isfinite(float(value)):
        return None
    return Metrics(name, {name: float(value)})


def train_net(category, cfg: TrainConfig, train_ds=None, val_ds=None,
              loss_mode: str = "schedule", model: Optional[Generator] = None,
              device=None) -> Dict:
    """Train one category end to end on ``device`` (default: the card).

    Returns ``{"history", "ckpt_dir", "trainer", "model"}``.
    """
    check_format(cfg.ckpt_format)
    device = resolve_device("cuda" if device is None else device)
    cat = category if isinstance(category, str) else "".join(category)
    if cfg.manual_seed is None:
        cfg.manual_seed = random.randint(1, 10000)
    np.random.seed(cfg.manual_seed)
    torch.manual_seed(cfg.manual_seed)

    if train_ds is None or val_ds is None:
        train_ds, val_ds = _build_datasets(cfg, category)
    train_loader = DataLoader(train_ds, cfg.batch_size, shuffle=True, drop_last=True,
                              seed=cfg.manual_seed)
    val_loader = DataLoader(val_ds, min(cfg.batch_size, max(len(val_ds), 1)),
                            shuffle=False, drop_last=False)

    output_dir = os.path.join(cfg.dir_path, cat)
    ckpt_dir = os.path.join(output_dir, "checkpoints")
    log_dir = os.path.join(output_dir, "logs", datetime.now().isoformat())
    os.makedirs(ckpt_dir, exist_ok=True)
    logger = get_logger(os.path.join(ckpt_dir, "logging.log"))
    train_writer = MetricWriter(os.path.join(log_dir, "train"))

    if model is None:
        with torch.device(device):
            model = Generator(num_points=cfg.num_points, backbone=cfg.backbone,
                              fine_width=cfg.fine_width, mid_width=cfg.mid_width)
        init_random_(model, torch.Generator(device=device).manual_seed(cfg.manual_seed))
    if cfg.pretrained_backbone:
        load_pretrained_backbone(model, cfg.pretrained_backbone)
    trainer = Trainer(model, cfg, loss_mode=loss_mode, device=device)

    best_chamfer: Optional[Metrics] = None
    best_emd: Optional[Metrics] = None
    all_epoch_time = 0.0
    start_epoch = cfg.start_epoch
    if cfg.resume:
        blob = _newest_checkpoint(ckpt_dir, cat, logger)
        model.load_state_dict(blob["state_dict"], strict=True)
        trainer.optimizer.load_state_dict(blob["optimizer"])
        start_epoch = int(blob.get("epoch", 0))
        all_epoch_time = float(blob.get("train_time", 0.0))
        # The running best: without it the first validation after a resume
        # would always win and could overwrite model_best with worse weights.
        best_chamfer = _restored_best(blob, "best_chamfer_loss", "ChamferDistance")
        best_emd = _restored_best(blob, "best_emd_loss", "EMD_distance")

    def checkpoint(epoch: int, is_best: bool) -> None:
        save_checkpoint({
            "state_dict": model.state_dict(),
            "optimizer": trainer.optimizer.state_dict(),
            "epoch": epoch,
            "train_time": all_epoch_time,
            "best_chamfer_loss": (best_chamfer.state_dict()["ChamferDistance"]
                                  if best_chamfer is not None else float("nan")),
            "best_emd_loss": (best_emd.state_dict()["EMD_distance"]
                              if best_emd is not None else float("nan")),
            "model_name": ckpt_dir,
        }, is_best, cat, ckpt_dir, epoch, fmt=cfg.ckpt_format)

    history = []
    for epoch in range(start_epoch + 1, cfg.nepoch + 1):
        t0 = time.time()
        epoch_stats = trainer.fit_epoch(train_loader, epoch, logger=logger,
                                        metric_writer=train_writer, category=cat)
        epoch_time = time.time() - t0
        all_epoch_time += epoch_time
        train_writer.add_scalar("Loss/Epoch/chamfer_loss", epoch_stats["chamfer_loss"], epoch)
        train_writer.add_scalar("Loss/Epoch/emd_loss", epoch_stats["emd_loss"], epoch)
        logger.info(
            "[[Category %s] Epoch %d/%d] EpochTime = %.3f (s) "
            "All_epoch_time = %.3f (s) Losses = %s",
            cat, epoch, cfg.nepoch, epoch_time, all_epoch_time,
            ["%.4f" % epoch_stats["chamfer_loss"], "%.4f" % epoch_stats["emd_loss"]],
        )
        history.append({"epoch": epoch, **epoch_stats})
        validate = epoch in tuple(cfg.validate_epochs) and len(val_ds) > 0

        # Periodic checkpoint between validations (0 disables); a validation
        # epoch writes its own.
        if cfg.train_save_freq > 0 and epoch % cfg.train_save_freq == 0 and not validate:
            checkpoint(epoch, False)

        if validate:
            cd_m, emd_m, summary = evaluate_dataset(
                model, val_loader, category=cat, logger=logger, device=device,
                icp_iterations=cfg.eval_icp_iterations,
                icp_tolerance=cfg.eval_icp_tolerance,
                emd_iters=cfg.eval_emd_iters, emd_eps=cfg.eval_emd_eps,
            )
            is_best = cd_m.better_than(best_chamfer) and emd_m.better_than(best_emd)
            if is_best:
                best_chamfer, best_emd = cd_m, emd_m
            checkpoint(epoch, is_best)
            history[-1]["val"] = summary

    train_writer.close()
    return {"history": history, "ckpt_dir": ckpt_dir, "trainer": trainer, "model": model}
