"""Finetune CLI on PyTorch (counterpart of ``fenet/cli/finetune.py``): the
projection loss 100·BCE + 100·CD + 100·EMD at lr 5e-5, resuming from the
category's newest checkpoint; fenet's flags, plus ``--device``.

``--nepoch`` is the last epoch, counted from the checkpoint's: resuming
from a ``model_best`` of epoch 50, ``--nepoch 60`` finetunes epochs 51-60,
and the default ``--nepoch 10`` runs none (fenet behaves the same).

    python -m fenet_torch.cli.finetune --device cuda --cats 02828884 \\
        --nepoch 60 --dir_path out/ --splits_path data/splits \\
        --data_dir_imgs data/ShapeNetRendering/ \\
        --data_dir_pcl data/ShapeNet_pointclouds/
"""

from __future__ import annotations

import argparse

from fenet_torch.cli.common import DEFAULT_TRAIN_CATS, add_common_args, config_from_args
from fenet_torch.parallel.distributed import finalize, initialize
from fenet_torch.train.driver import train_net


def main(argv=None):
    parser = add_common_args(argparse.ArgumentParser())
    parser.add_argument("--cats", nargs="*", default=None,
                        help="category ids to finetune (default: the reference's)")
    parser.add_argument("--grid_h", type=int, default=64)
    parser.add_argument("--grid_w", type=int, default=64)
    parser.add_argument("--SIGMA_SQ", type=float, default=2.0)
    parser.add_argument("--OUTPUT_PCL_SIZE", type=int, default=1024)
    parser.add_argument("--proj_squash", action="store_true",
                        help="apply tanh to the splat silhouettes so the BCE "
                             "term is bounded below (the reference's raw sum "
                             "is not a probability)")
    parser.set_defaults(nepoch=10, lr=5e-5, resume=True)
    opt = parser.parse_args(argv)
    initialize(device=opt.device)  # a no-op on a single process
    print(opt)

    cats = opt.cats or ([opt.category] if opt.category else DEFAULT_TRAIN_CATS)
    results = {}
    for cat in cats:
        cfg = config_from_args(opt)
        cfg.category = cat
        cfg.grid_h, cfg.grid_w = opt.grid_h, opt.grid_w
        cfg.sigma_sq = opt.SIGMA_SQ
        cfg.output_pcl_size = opt.OUTPUT_PCL_SIZE
        cfg.proj_squash = opt.proj_squash
        results[cat] = train_net(cat, cfg, loss_mode="finetune", device=opt.device)
    finalize()
    return results


if __name__ == "__main__":
    main()
