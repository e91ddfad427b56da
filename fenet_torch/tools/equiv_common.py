"""What the port's training-evidence tools share (counterpart of fenet's
``tools/equiv_common.py``): the synthetic batches (seed 0, clouds in [0,
0.9)), the timed training loop of one arm, and the records' device line.

The tools (``eps_scaling_equiv``, ``sinkhorn_equiv``, ``finetune_convergence``)
run on ``cuda`` unless ``--device cpu`` is given, and write their records
under ``docs/torch_*.json``, beside fenet's, which they never write.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from fenet_torch.models.generator import Generator, init_random_
from fenet_torch.train.trainer import Trainer, reference_lr_schedule

ROOT = Path(__file__).resolve().parent.parent.parent
NUM_POINTS = 1024


def make_batches(steps: int, batch: int, seed: int = 0):
    """``steps`` (images, points) batches + one held-out batch, fixed seed
    so every arm sees the identical data order."""
    rng = np.random.RandomState(seed)

    def one():
        return ((rng.rand(batch, 128, 128, 3) * 255).astype(np.float32),
                (rng.rand(batch, NUM_POINTS, 3) * 0.9).astype(np.float32))

    return [one() for _ in range(steps)], one()


def initial_state(cfg) -> dict:
    """The arms' initial weights: the generator of ``cfg``'s widths at 1024
    points, filled by ``init_random_`` from a CPU ``torch.Generator`` seeded
    0, so the init is the same on every device."""
    gen = Generator(num_points=NUM_POINTS, backbone=cfg.backbone, fine_width=cfg.fine_width,
                    mid_width=cfg.mid_width)
    init_random_(gen, torch.Generator().manual_seed(0))
    return gen.state_dict()


def new_trainer(cfg, state_dict: dict, device, loss_mode: str = "schedule") -> Trainer:
    """A Trainer on ``device`` around a generator loaded with ``state_dict``
    (copied in: the trainer's weights never alias it)."""
    gen = Generator(num_points=NUM_POINTS, backbone=cfg.backbone, fine_width=cfg.fine_width,
                    mid_width=cfg.mid_width)
    gen.load_state_dict(state_dict, strict=True)
    return Trainer(gen, cfg, loss_mode=loss_mode, device=device)


def train_arm(cfg, batches, steps_per_epoch: int, label: str, device="cuda",
              state_dict: dict | None = None):
    """Train from ``state_dict`` (default :func:`initial_state`) over
    ``batches``; returns (per-step losses, per-step walls, trainer). Each
    step's wall is on the host clock and ends with the losses read back,
    which waits for the step."""
    trainer = new_trainer(cfg, initial_state(cfg) if state_dict is None else state_dict, device)
    hist, walls = [], []
    for i, (img, pts) in enumerate(batches):
        epoch = 1 + i // steps_per_epoch
        lr = reference_lr_schedule(cfg.lr, epoch)
        t0 = time.time()
        stats = trainer.train_step(img, pts, epoch=epoch, lr=lr)
        losses = {k: float(v) for k, v in stats.items()}  # waits for the step
        walls.append(time.time() - t0)
        hist.append(losses)
        print(json.dumps({"arm": label, "step": i, "wall_s": round(walls[-1], 3), **losses}),
              flush=True)
    return hist, walls, trainer


def wall_sans_compile(walls):
    """Sum of per-step walls excluding the first (warm-up) step; a small
    floor keeps single-step runs from dividing by zero downstream."""
    return max(sum(walls[1:]), 1e-9)


def device_label(device: torch.device) -> str:
    """The record's ``device``: nvidia-smi's name and power limit of a card,
    or ``cpu``."""
    if device.type != "cuda":
        return device.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def write_record(record: dict, out: str, **dump) -> None:
    with open(out, "w") as f:
        json.dump(record, f, indent=1, **dump)
        f.write("\n")
