"""Training-equivalence and wall-time record for adaptive eps-scaling
(counterpart of fenet's ``tools/eps_scaling_equiv.py``).

    python -m fenet_torch.tools.eps_scaling_equiv [--steps 24] [--batch 128]
        [--steps_per_epoch 8] [--out docs/torch_eps_scaling_equiv.json]
        [--device cuda]

Runs the same synthetic training twice, the strict reference auction
(``emd_scale_phases=1``, the default) against adaptive scaling
(``--emd_scale_phases 3 --emd_scale_thresh 0.3``), from the same seeded
init on identical data order, at the reference's settings (RepVGG-A2, 1024
points, batch 128, CD+EMD at eps 0.05 and 3000 iterations, Adam). Records
each arm's per-step losses, its final losses, its wall without the first
step, and the ratio of the walls, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys

from fenet_torch.tools import equiv_common
from fenet_torch.train.config import TrainConfig
from fenet_torch.utils.device import resolve_device

DEFAULT_OUT = equiv_common.ROOT / "docs" / "torch_eps_scaling_equiv.json"


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=24)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--steps_per_epoch", type=int, default=8)
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def run(argv=None, **config) -> dict:
    """Run both arms and write the record; returns it. ``config``
    overrides TrainConfig fields (a small model for a test)."""
    opt = parse_args(argv)
    device = resolve_device(opt.device)
    batches, _ = equiv_common.make_batches(opt.steps, opt.batch)

    def cfg_of(scale_phases, scale_thresh):
        return TrainConfig(batch_size=opt.batch, emd_scale_phases=scale_phases,
                           emd_scale_thresh=scale_thresh, **config)

    strict_cfg = cfg_of(1, 0.0)
    init = equiv_common.initial_state(strict_cfg)

    def arm(cfg, label):
        hist, walls, _ = equiv_common.train_arm(cfg, batches, opt.steps_per_epoch, label,
                                                device, init)
        return hist, walls

    strict_hist, strict_w = arm(strict_cfg, "phases=1")
    adapt_hist, adapt_w = arm(cfg_of(3, 0.3), "phases=3")

    s_wall = equiv_common.wall_sans_compile(strict_w)
    a_wall = equiv_common.wall_sans_compile(adapt_w)
    final_s, final_a = strict_hist[-1], adapt_hist[-1]
    rel = {k: abs(final_s[k] - final_a[k]) / max(abs(final_s[k]), 1e-9)
           for k in ("chamfer_loss", "emd_loss", "total_loss")}
    record = {
        "settings": {
            "batch": opt.batch, "steps": opt.steps, "steps_per_epoch": opt.steps_per_epoch,
            "emd": f"eps={strict_cfg.emd_eps} iters={strict_cfg.emd_iters} "
                   "(train.py:36-46, loss.py:23)",
            "seed": 0, "identical_data_order": True,
        },
        "strict": {"final": final_s, "wall_seconds_sans_compile": round(s_wall, 2),
                   "per_step": strict_hist},
        "adaptive": {"final": final_a, "wall_seconds_sans_compile": round(a_wall, 2),
                     "per_step": adapt_hist,
                     "flags": "--emd_scale_phases 3 --emd_scale_thresh 0.3"},
        "final_loss_rel_diff": {k: round(v, 5) for k, v in rel.items()},
        "speedup_strict_over_adaptive_wall_ratio": round(s_wall / a_wall, 3),
        "device": equiv_common.device_label(device),
    }
    equiv_common.write_record(record, opt.out)
    print(json.dumps({
        "out": opt.out, "speedup": record["speedup_strict_over_adaptive_wall_ratio"],
        "final_loss_rel_diff": record["final_loss_rel_diff"]}), flush=True)
    return record


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
