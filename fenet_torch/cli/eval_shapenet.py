"""ShapeNet 13-category eval CLI on PyTorch (counterpart of
``fenet/cli/eval_shapenet.py``): same flags, plus ``--device``.

Weights come from ``{--model % cat}/model_best.pth.tar``, the reference's
checkpoint format (``{"state_dict": ...}``), or where there is none from
fenet's ``model_best.ckpt``.

    python -m fenet_torch.cli.eval_shapenet --model out/%s/checkpoints/ \\
        --splits_path data/splits --data_dir_imgs ... --data_dir_pcl ...
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from fenet_torch.cli.common import require_checkpoints
from fenet_torch.data.loader import DataLoader
from fenet_torch.data.shapenet import ShapeNetDataset, load_split
from fenet_torch.eval.runner import evaluate_dataset
from fenet_torch.models.convert import load_reference_checkpoint
from fenet_torch.models.generator import Generator, to_deploy
from fenet_torch.parallel.distributed import finalize, initialize, is_primary, shard_for_process
from fenet_torch.utils.device import resolve_device
from fenet_torch.utils.logger import get_logger

# The 13 categories of the reference's eval.
ALL_CATS = [
    "02691156", "02828884", "02933112", "02958343", "03636649", "03211117",
    "04090263", "03001627", "04530566", "04379243", "03691459", "04401088",
    "04256520",
]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batchSize", type=int, default=64)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--num_points", type=int, default=1024)
    parser.add_argument("--model", type=str,
                        default="./output/fenet/%s/checkpoints/")
    parser.add_argument("--splits_path", type=str, default="./data/splits/")
    parser.add_argument("--data_dir_imgs", type=str,
                        default="./data/shapenet/ShapeNetRendering/")
    parser.add_argument("--data_dir_pcl", type=str,
                        default="./data/shapenet/ShapeNet_pointclouds/")
    parser.add_argument("--backbone", type=str, default="RepVGG-A2")
    parser.add_argument("--fine_width", type=int, default=512,
                        help="decoder fine-head per-point channels")
    parser.add_argument("--mid_width", type=int, default=128,
                        help="decoder mid-head per-point channels")
    parser.add_argument("--cats", nargs="*", default=ALL_CATS)
    parser.add_argument("--no_icp", action="store_true")
    parser.add_argument("--icp_iters", type=int, default=1024)
    parser.add_argument("--icp_patience", type=int, default=32,
                        help="stop an element after this many non-improving "
                             "ICP iterations (0 = reference full budget)")
    parser.add_argument("--icp_rel_tolerance", type=float, default=None,
                        help="fp32 relative plateau exit; default 1e-6, or 0 "
                             "(strict full-budget semantics) when "
                             "--icp_patience is 0")
    parser.add_argument("--emd_iters", type=int, default=50)
    parser.add_argument("--icp_coarse_points", type=int, default=0,
                        help="coarse-to-fine ICP warm start on this many "
                             "stride-subsampled points (0 = off)")
    parser.add_argument("--deploy", action="store_true",
                        help="fold BN and RepVGG branches (float32) before "
                             "eval")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    opt = parser.parse_args(argv)
    if opt.icp_rel_tolerance is None:
        opt.icp_rel_tolerance = 0.0 if opt.icp_patience == 0 else 1e-6
    initialize(device=opt.device)  # a no-op on a single process
    print(opt)
    device = resolve_device(opt.device)
    ckpts = require_checkpoints(parser, opt.model, opt.cats)

    val_models = load_split(opt.splits_path, "val_models.json")
    results = {}
    for cat in opt.cats:
        ckpt_dir = opt.model % cat
        # Each rank evaluates its shard; rank 0 logs and prints the sums.
        logger = get_logger(os.path.join(ckpt_dir, "logging_test.log")) if is_primary() else None
        with torch.device(device):
            gen = Generator(num_points=opt.num_points, backbone=opt.backbone,
                            fine_width=opt.fine_width, mid_width=opt.mid_width)
        load_reference_checkpoint(gen, ckpts[cat])
        if opt.deploy:
            gen = to_deploy(gen)
        ds = ShapeNetDataset(
            opt.data_dir_imgs, opt.data_dir_pcl, val_models, [cat],
            opt.num_points, multi_resolution=False, check_exists=True,
            image_dtype="uint8",
        )
        loader = DataLoader(shard_for_process(ds), opt.batchSize, drop_last=False)
        _, _, summary = evaluate_dataset(
            gen, loader, category=cat, logger=logger, device=device,
            align=not opt.no_icp, icp_iterations=opt.icp_iters,
            icp_patience=opt.icp_patience,
            icp_rel_tolerance=opt.icp_rel_tolerance,
            icp_coarse_points=opt.icp_coarse_points,
            emd_iters=opt.emd_iters,
        )
        results[cat] = summary
        if is_primary():
            print(cat, json.dumps(summary))
    if results and is_primary():
        mean_cd = float(np.mean([r["ChamferDistance"] for r in results.values()]))
        mean_emd = float(np.mean([r["EMD_distance"] for r in results.values()]))
        print(json.dumps({"mean_cd": mean_cd, "mean_emd": mean_emd}))
    finalize()
    return results


if __name__ == "__main__":
    main()
