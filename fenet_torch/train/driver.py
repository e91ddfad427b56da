"""End-to-end per-category training (counterpart of
``fenet/train/driver.py``): seeded init, a shuffled DataLoader, resume from
the newest checkpoint, periodic saves, and validation with a best copy.

On several processes (:mod:`fenet_torch.parallel`) every rank takes rank
0's seed, the data-parallel mesh is sized from the world (``data_parallel``
1 means the world size), both datasets are sharded per rank with the local
batch size, only rank 0 writes the log, the scalars and the checkpoints
(the others log warnings only), and a resume loads on rank 0 and
broadcasts. Every rank holds the whole model, so a checkpoint moves between
runs of any number of ranks.
"""

from __future__ import annotations

import json
import logging
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
from fenet_torch.parallel.distributed import (
    ProcessShardDataset,
    is_primary,
    local_batch_size,
    process_rank,
    world_size,
)
from fenet_torch.parallel.mesh import broadcast_object, broadcast_tree, make_mesh
from fenet_torch.train.checkpoint import (
    SUFFIXES,
    check_format,
    checkpoint_epoch,
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


def _newest_checkpoint(ckpt_dir: str, cat: str, fmt: str, logger):
    """The highest-epoch checkpoint in any container, as fenet's resume
    picks it: a periodic save after the last validation must win over an
    older model_best. At equal epochs ``fmt``'s container wins, and a
    model_best over a periodic save."""
    suffixes = (SUFFIXES[fmt],) + tuple(s for s in SUFFIXES.values() if s != SUFFIXES[fmt])
    newest = None  # (epoch, path)
    for suffix in suffixes:
        path = os.path.join(ckpt_dir, "model_best" + suffix)
        if os.path.exists(path):
            epoch = checkpoint_epoch(path)
            if newest is None or epoch > newest[0]:
                newest = (epoch, path)
    for suffix in suffixes:
        periodic = latest_checkpoint(ckpt_dir, cat, suffix)
        if periodic is not None:
            epoch = int(periodic[: -len(suffix)].rsplit("_", 1)[1])
            if newest is None or epoch > newest[0]:
                logger.info("resume: periodic checkpoint %s (epoch %d) is newest", periodic,
                            epoch)
                newest = (epoch, periodic)
    if newest is None:
        raise FileNotFoundError(f"--resume: no checkpoint under {ckpt_dir}")
    return load_checkpoint(newest[1])


def _broadcast_checkpoint(ckpt_dir: str, cat: str, fmt: str, logger) -> Dict:
    """The newest checkpoint, loaded on rank 0 (the only rank that writes
    them, so the directory may be rank 0's alone) and broadcast. Rank 0
    reports a failure to load before the tensors' broadcast, so that every
    rank raises instead of waiting on it."""
    blob, error = None, None
    if is_primary():
        try:
            blob = _newest_checkpoint(ckpt_dir, cat, fmt, logger)
        except Exception as e:  # any failure to load: re-raised on every rank below
            error = f"{type(e).__name__}: {e}"
            logger.error("resume: %s", error)
    error = broadcast_object(error)
    if error is not None:
        raise RuntimeError(f"--resume: rank 0 could not load a checkpoint under {ckpt_dir}: "
                           f"{error}")
    return broadcast_tree(blob)


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
    """Train one category end to end on ``device`` (default: the card), in
    ``loss_mode`` "schedule" (train) or "finetune".

    The epochs run are ``start_epoch + 1 .. cfg.nepoch``; with ``cfg.resume``
    ``start_epoch`` is the checkpoint's epoch, as in fenet. So a finetune
    resumed from a checkpoint of epoch E runs no epoch unless ``cfg.nepoch``
    exceeds E, and its LR is ``reference_lr_schedule(cfg.lr, epoch)`` at
    those epochs.

    On several processes every rank calls it with the same arguments (its
    ``model`` on its own device); ``cfg.data_parallel`` is set to the
    mesh's size.

    Returns ``{"history", "ckpt_dir", "trainer", "model"}``.
    """
    check_format(cfg.ckpt_format)
    device = resolve_device("cuda" if device is None else device)
    cat = category if isinstance(category, str) else "".join(category)
    if cfg.manual_seed is None:
        cfg.manual_seed = random.randint(1, 10000)
    multi = world_size() > 1
    if multi:  # every rank must init and shuffle as rank 0 does
        cfg.manual_seed = broadcast_object(cfg.manual_seed)
    np.random.seed(cfg.manual_seed)
    torch.manual_seed(cfg.manual_seed)
    mesh = make_mesh(cfg.data_parallel)
    cfg.data_parallel = mesh.dp

    if train_ds is None or val_ds is None:
        train_ds, val_ds = _build_datasets(cfg, category)
    batch_size = cfg.batch_size
    if multi:  # each rank reads its shard
        batch_size = local_batch_size(cfg.batch_size)
        train_ds = ProcessShardDataset(train_ds)
        if len(val_ds):
            val_ds = ProcessShardDataset(val_ds)
    train_loader = DataLoader(train_ds, batch_size, shuffle=True, drop_last=True,
                              seed=cfg.manual_seed)
    val_loader = DataLoader(val_ds, min(batch_size, max(len(val_ds), 1)),
                            shuffle=False, drop_last=False)

    output_dir = os.path.join(cfg.dir_path, cat)
    ckpt_dir = os.path.join(output_dir, "checkpoints")
    log_dir = os.path.join(output_dir, "logs", datetime.now().isoformat())
    primary = is_primary()
    if primary:
        os.makedirs(ckpt_dir, exist_ok=True)
        logger = get_logger(os.path.join(ckpt_dir, "logging.log"))
        train_writer = MetricWriter(os.path.join(log_dir, "train"))
    else:  # no file of its own; warnings reach stderr
        logger = logging.getLogger(f"fenet_torch.worker{process_rank()}")
        train_writer = None

    if model is None:
        with torch.device(device):
            model = Generator(num_points=cfg.num_points, backbone=cfg.backbone,
                              fine_width=cfg.fine_width, mid_width=cfg.mid_width)
        init_random_(model, torch.Generator(device=device).manual_seed(cfg.manual_seed))
    if cfg.pretrained_backbone:
        load_pretrained_backbone(model, cfg.pretrained_backbone)
    trainer = Trainer(model, cfg, loss_mode=loss_mode, device=device, mesh=mesh)

    best_chamfer: Optional[Metrics] = None
    best_emd: Optional[Metrics] = None
    all_epoch_time = 0.0
    start_epoch = cfg.start_epoch
    if cfg.resume:
        blob = (_broadcast_checkpoint(ckpt_dir, cat, cfg.ckpt_format, logger) if multi
                else _newest_checkpoint(ckpt_dir, cat, cfg.ckpt_format, logger))
        trainer.load_full_state(blob["state_dict"], blob["optimizer"])
        start_epoch = int(blob.get("epoch", 0))
        all_epoch_time = float(blob.get("train_time", 0.0))
        # The running best: without it the first validation after a resume
        # would always win and could overwrite model_best with worse weights.
        best_chamfer = _restored_best(blob, "best_chamfer_loss", "ChamferDistance")
        best_emd = _restored_best(blob, "best_emd_loss", "EMD_distance")

    def checkpoint(epoch: int, is_best: bool) -> None:
        state_dict, optimizer = trainer.full_state()
        if not primary:
            return
        # The scalars in fenet's order: a flax checkpoint's sidecar is fenet's.
        save_checkpoint({
            "state_dict": state_dict,
            "optimizer": optimizer,
            "epoch": epoch,
            "model_name": ckpt_dir,
            "train_time": all_epoch_time,
            "best_chamfer_loss": (float(best_chamfer.state_dict()["ChamferDistance"])
                                  if best_chamfer is not None else float("nan")),
            "best_emd_loss": (float(best_emd.state_dict()["EMD_distance"])
                              if best_emd is not None else float("nan")),
        }, is_best, cat, ckpt_dir, epoch, fmt=cfg.ckpt_format)

    history = []
    for epoch in range(start_epoch + 1, cfg.nepoch + 1):
        t0 = time.time()
        epoch_stats = trainer.fit_epoch(train_loader, epoch, logger=logger,
                                        metric_writer=train_writer, category=cat)
        epoch_time = time.time() - t0
        all_epoch_time += epoch_time
        if train_writer is not None:
            train_writer.add_scalar("Loss/Epoch/chamfer_loss", epoch_stats["chamfer_loss"],
                                    epoch)
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

    if train_writer is not None:
        train_writer.close()
    return {"history": history, "ckpt_dir": ckpt_dir, "trainer": trainer, "model": model}
