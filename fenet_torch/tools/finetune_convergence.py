"""Finetune convergence record, the evidence for the ``bce_prob`` floor
(counterpart of fenet's ``tools/finetune_convergence.py``).

    python -m fenet_torch.tools.finetune_convergence
        [--out docs/torch_finetune_convergence.json] [--device cuda]

The finetune step is differentiable through the projected silhouettes, and
without the floor on the log argument of ``bce_prob`` a saturated splat
cell sends the gradient to infinity and the weights to NaN after one update
(``fenet_torch/losses/projection.py``). This tool runs the finetune flow of
the reference (finetune.py:115-182) on one fixed synthetic batch and
records the loss traces: WARM_STEPS schedule-loss steps standing in for the
resumed checkpoint, then FINETUNE_STEPS finetune steps at lr 5e-5 with
total = 100·BCE + 100·CD + 100·EMD, twice from the same warm state (weights,
Adam moments and step count): the faithful raw-sum silhouettes and the
``proj_squash`` tanh composition (CAPNet).

Pass rule: every loss finite in all three phases, and the reconstruction
(CD + EMD) preserved in the squashed phase: the mean of its last 5 steps at
most 1.5× the mean of its first 5. The faithful phase's reconstruction is
recorded, not gated: the reference's ``bce_prob`` on raw splat sums is
unbounded below, so its total trades that term against CD and EMD. The exit
code is 1 when the rule fails.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

from fenet_torch.tools import equiv_common
from fenet_torch.train.config import TrainConfig
from fenet_torch.utils.device import resolve_device

WARM_STEPS = 20      # schedule-loss stand-in for the resumed checkpoint
FINETUNE_STEPS = 30
BATCH = 32
FINETUNE_LR = 5e-5   # finetune.py's
EPOCH = 1
PHASES = ("faithful", "squash")
DEFAULT_OUT = equiv_common.ROOT / "docs" / "torch_finetune_convergence.json"


def fixed_batch(batch: int, seed: int = 0):
    """The one batch every step sees: images, then clouds in [-0.45, 0.45)."""
    rng = np.random.RandomState(seed)
    images = rng.rand(batch, 128, 128, 3).astype(np.float32) * 255
    points = (rng.rand(batch, equiv_common.NUM_POINTS, 3).astype(np.float32) - 0.5) * 0.9
    return images, points


def run_phase(trainer, images, points, steps: int, lr: float, epoch: int = EPOCH) -> list:
    """``steps`` train steps on one batch; each step's total, CD and EMD."""
    trace = []
    for _ in range(steps):
        stats = trainer.train_step(images, points, epoch=epoch, lr=lr)
        trace.append({"total": float(stats["total_loss"]), "cd": float(stats["chamfer_loss"]),
                      "emd": float(stats["emd_loss"])})
    return trace


def finetune_sequence(cfg, images, points, warm_steps: int, finetune_steps: int, device,
                      state_dict: dict, phases=PHASES) -> dict:
    """The warm phase from ``state_dict``, then each finetune phase of
    ``phases`` from its own copy of the warm state: the weights and the Adam
    state, so no phase advances the state another starts from. {phase:
    trace}."""
    warm = equiv_common.new_trainer(cfg, state_dict, device, loss_mode="schedule")
    traces = {"warm": run_phase(warm, images, points, warm_steps, cfg.lr)}
    weights = {k: v.detach().clone() for k, v in warm.model.state_dict().items()}
    adam = copy.deepcopy(warm.optimizer.state_dict())
    del warm
    for phase in phases:
        phase_cfg = dataclasses.replace(cfg, proj_squash=phase == "squash")
        trainer = equiv_common.new_trainer(phase_cfg, weights, device, loss_mode="finetune")
        trainer.optimizer.load_state_dict(copy.deepcopy(adam))
        traces[phase] = run_phase(trainer, images, points, finetune_steps, FINETUNE_LR)
        del trainer
    return traces


def commit() -> str:
    """The checkout's short commit, or "" where it is no git repository (a
    ``git archive`` tree)."""
    if not (equiv_common.ROOT / ".git").exists():
        return ""
    out = subprocess.run(["git", "rev-parse", "--short", "HEAD"], cwd=equiv_common.ROOT,
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip() if out.returncode == 0 else ""


def head_tail(trace):
    """Means of CD + EMD over the first and the last 5 steps."""
    recon = [s["cd"] + s["emd"] for s in trace]
    return float(np.mean(recon[:5])), float(np.mean(recon[-5:]))


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def run(argv=None, warm_steps: int = WARM_STEPS, finetune_steps: int = FINETUNE_STEPS,
        batch: int = BATCH, **config) -> dict:
    """Run the three phases and write the record; returns it. ``config``
    overrides TrainConfig fields (a small model for a test)."""
    opt = parse_args(argv)
    device = resolve_device(opt.device)
    images, points = fixed_batch(batch)
    cfg = TrainConfig(batch_size=batch, **config)
    t0 = time.time()
    traces = finetune_sequence(cfg, images, points, warm_steps, finetune_steps, device,
                               equiv_common.initial_state(cfg))
    warm_trace, ft_trace, sq_trace = traces["warm"], traces["faithful"], traces["squash"]
    finite = all(np.isfinite(v) for s in warm_trace + ft_trace + sq_trace for v in s.values())
    recon_head, recon_tail = head_tail(ft_trace)
    sq_head, sq_tail = head_tail(sq_trace)

    def rounded(trace):
        return [{k: round(v, 4) for k, v in s.items()} for s in trace]

    record = {
        "commit": commit(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "batch": batch,
        "warm_steps": warm_steps,
        "finetune_steps": finetune_steps,
        "finetune_lr": FINETUNE_LR,
        "loss": f"{cfg.lambda_bce:g}*BCE({cfg.grid_h}x{cfg.grid_w} silhouettes) + "
                f"{cfg.lambda_cd:g}*CD + {cfg.lambda_emd:g}*EMD({cfg.emd_eps},{cfg.emd_iters})",
        "warm_trace": rounded(warm_trace),
        "finetune_trace": rounded(ft_trace),
        "squash_trace": rounded(sq_trace),
        "all_finite": finite,
        "recon_head_mean5": round(recon_head, 4),
        "recon_tail_mean5": round(recon_tail, 4),
        "squash_recon_head_mean5": round(sq_head, 4),
        "squash_recon_tail_mean5": round(sq_tail, 4),
        "reconstruction_preserved": bool(sq_tail <= 1.5 * sq_head),
        "wall_seconds": round(time.time() - t0, 1),
        "note": (
            "fixed synthetic batch; the bce_prob log floor is what keeps these "
            "traces finite. The total includes the reference-faithful bce_prob "
            "term, which is negative at saturated silhouettes (not a proper "
            "scoring rule on splat sums); cd/emd are the reconstruction "
            "components. squash_trace is the same phase with proj_squash "
            "(CAPNet tanh composition, bounded-below BCE) from the same warm "
            "state: weights, Adam moments and step count."
        ),
        "device": equiv_common.device_label(device),
    }
    equiv_common.write_record(record, opt.out, sort_keys=True)
    print(json.dumps({k: record[k] for k in
                      ("all_finite", "reconstruction_preserved", "recon_head_mean5",
                       "recon_tail_mean5", "squash_recon_head_mean5",
                       "squash_recon_tail_mean5", "wall_seconds")}), flush=True)
    return record


def main(argv=None) -> int:
    record = run(argv)
    return 0 if record["all_finite"] and record["reconstruction_preserved"] else 1


if __name__ == "__main__":
    sys.exit(main())
