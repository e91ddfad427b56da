"""Training-equivalence and wall-time record for the Sinkhorn EMD mode
(counterpart of fenet's ``tools/sinkhorn_equiv.py``).

    python -m fenet_torch.tools.sinkhorn_equiv [--steps 24] [--batch 128]
        [--steps_per_epoch 8] [--out docs/torch_sinkhorn_equiv.json]
        [--device cuda]

Runs the same synthetic training twice, the default auction EMD (the
reference's semantics) against ``--emd_impl sinkhorn`` (annealed entropic
OT), from the same seeded init on identical data order at the reference's
settings (RepVGG-A2, 1024 points, batch 128, Adam). Each arm's emd_loss
column comes from its own EMD, so the arms compare through the shared
chamfer_loss column and the cross-eval: after training, both final models
are scored on a held-out batch with CD and the strict auction EMD (eps
0.05, 3000 iterations), BatchNorm in train mode as fenet's ``score`` runs
it. Records per-step losses, final losses, the cross-eval, each arm's wall
without the first step and the ratio of the walls, with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import sys

import torch

from fenet_torch.losses.facade import chamfer_loss, emd_loss
from fenet_torch.tools import equiv_common
from fenet_torch.train.config import TrainConfig
from fenet_torch.utils.device import resolve_device

DEFAULT_OUT = equiv_common.ROOT / "docs" / "torch_sinkhorn_equiv.json"


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=24)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--steps_per_epoch", type=int, default=8)
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


@torch.no_grad()
def score(model: torch.nn.Module, images, points) -> dict:
    """CD and the strict auction EMD (0.05, 3000) of ``model``'s clouds on
    a held-out batch, with BatchNorm in train mode (batch statistics), as
    fenet's ``score`` applies its model. The forward runs on a copy: the
    running statistics it updates never reach ``model``."""
    scorer = copy.deepcopy(model).train()
    device = next(model.parameters()).device
    pts = torch.as_tensor(points).to(device, torch.float32)
    _, _, pc3 = scorer(torch.as_tensor(images).to(device))
    return {"chamfer": float(chamfer_loss(pc3, pts)),
            "auction_emd": float(emd_loss(pc3, pts, 0.05, 3000))}


def run(argv=None, **config) -> dict:
    """Run both arms and their cross-eval and write the record; returns it.
    ``config`` overrides TrainConfig fields (a small model for a test)."""
    opt = parse_args(argv)
    device = resolve_device(opt.device)
    batches, held_out = equiv_common.make_batches(opt.steps, opt.batch)
    cfg = TrainConfig(batch_size=opt.batch, **config)
    init = equiv_common.initial_state(cfg)

    def arm(emd_impl):
        hist, walls, trainer = equiv_common.train_arm(
            dataclasses.replace(cfg, emd_impl=emd_impl), batches, opt.steps_per_epoch,
            emd_impl, device, init)
        cross = score(trainer.model, *held_out)
        print(json.dumps({"arm": emd_impl, "cross_eval": cross}), flush=True)
        return hist, walls, cross

    a_hist, a_w, a_cross = arm("auction")
    s_hist, s_w, s_cross = arm("sinkhorn")

    a_wall = equiv_common.wall_sans_compile(a_w)
    s_wall = equiv_common.wall_sans_compile(s_w)
    record = {
        "settings": {
            "batch": opt.batch, "steps": opt.steps, "steps_per_epoch": opt.steps_per_epoch,
            "auction": f"eps={cfg.emd_eps} iters={cfg.emd_iters} (loss/loss.py:23)",
            "sinkhorn": f"blur={cfg.sinkhorn_blur} x {cfg.sinkhorn_iters} annealed iters "
                        "(losses/sinkhorn.py defaults)",
            "seed": 0, "identical_data_order": True,
        },
        "auction": {"final": a_hist[-1], "cross_eval": a_cross,
                    "wall_seconds_sans_compile": round(a_wall, 2), "per_step": a_hist},
        "sinkhorn": {"final": s_hist[-1], "cross_eval": s_cross,
                     "wall_seconds_sans_compile": round(s_wall, 2), "per_step": s_hist},
        "cross_eval_rel_diff": {
            k: round(abs(a_cross[k] - s_cross[k]) / max(abs(a_cross[k]), 1e-9), 5)
            for k in a_cross},
        "speedup_auction_over_sinkhorn_wall_ratio": round(a_wall / s_wall, 3),
        "device": equiv_common.device_label(device),
    }
    equiv_common.write_record(record, opt.out)
    print(json.dumps({"out": opt.out,
                      "speedup": record["speedup_auction_over_sinkhorn_wall_ratio"],
                      "cross_eval_rel_diff": record["cross_eval_rel_diff"]}), flush=True)
    return record


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
