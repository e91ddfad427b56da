"""Pix3D generalisation eval CLI on PyTorch (counterpart of
``fenet/cli/eval_pix3d.py``): the same flags, plus ``--device``.

Pix3D's chair, sofa and table are scored with the weights of their ShapeNet
category, ``{--model % id}/model_best.pth.tar`` (the reference's
container) or fenet's ``model_best.ckpt``, through ``evaluate_dataset``:
ICP-aligned CD and EMD on the masked real images.

    python -m fenet_torch.cli.eval_pix3d --device cuda --data_dir data/pix3d/ \\
        --model out/%s/checkpoints/
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from fenet_torch.cli.common import require_checkpoints
from fenet_torch.data.loader import DataLoader
from fenet_torch.data.pix3d import Pix3DDataset
from fenet_torch.eval.runner import evaluate_dataset
from fenet_torch.models.convert import load_reference_checkpoint
from fenet_torch.models.generator import Generator, to_deploy
from fenet_torch.parallel.distributed import finalize, initialize, is_primary, shard_for_process
from fenet_torch.utils.device import resolve_device
from fenet_torch.utils.logger import get_logger

# Pix3D category -> ShapeNet checkpoint id.
PIX3D_TO_SHAPENET = {
    "chair": "03001627",
    "sofa": "04256520",
    "table": "04379243",
}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--batchSize", type=int, default=32)
    parser.add_argument("--num_points", type=int, default=1024)
    parser.add_argument("--model", type=str, default="./output/fenet/%s/checkpoints/")
    parser.add_argument("--data_dir", type=str, default="./data/pix3d/")
    parser.add_argument("--backbone", type=str, default="RepVGG-A2")
    parser.add_argument("--fine_width", type=int, default=512,
                        help="decoder fine-head per-point channels")
    parser.add_argument("--mid_width", type=int, default=128,
                        help="decoder mid-head per-point channels")
    parser.add_argument("--cats", nargs="*", default=["sofa", "table", "chair"])
    parser.add_argument("--icp_iters", type=int, default=1024)
    parser.add_argument("--icp_patience", type=int, default=32,
                        help="stop an element after this many non-improving "
                             "ICP iterations (0 = reference full budget)")
    parser.add_argument("--icp_rel_tolerance", type=float, default=None,
                        help="fp32 relative plateau exit; default 1e-6, or 0 "
                             "(strict full-budget semantics) when "
                             "--icp_patience is 0")
    parser.add_argument("--icp_coarse_points", type=int, default=0,
                        help="coarse-to-fine ICP warm start on this many "
                             "stride-subsampled points (0 = off)")
    parser.add_argument("--emd_iters", type=int, default=50)
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
    ckpts = require_checkpoints(parser, opt.model, (PIX3D_TO_SHAPENET[c] for c in opt.cats))

    results = {}
    for cat in opt.cats:
        ckpt_dir = opt.model % PIX3D_TO_SHAPENET[cat]
        # Each rank evaluates its shard; rank 0 logs and prints the sums.
        logger = get_logger(os.path.join(ckpt_dir, "logging_pix3d.log")) if is_primary() else None
        with torch.device(device):
            gen = Generator(num_points=opt.num_points, backbone=opt.backbone,
                            fine_width=opt.fine_width, mid_width=opt.mid_width)
        load_reference_checkpoint(gen, ckpts[PIX3D_TO_SHAPENET[cat]])
        if opt.deploy:
            gen = to_deploy(gen)
        ds = Pix3DDataset(opt.data_dir, category=cat, num_points=opt.num_points)
        loader = DataLoader(shard_for_process(ds), opt.batchSize, drop_last=False)
        _, _, summary = evaluate_dataset(
            gen, loader, category=cat, logger=logger, device=device,
            icp_iterations=opt.icp_iters, icp_patience=opt.icp_patience,
            icp_rel_tolerance=opt.icp_rel_tolerance,
            icp_coarse_points=opt.icp_coarse_points, emd_iters=opt.emd_iters,
        )
        results[cat] = summary
        if is_primary():
            print(cat, json.dumps(summary))
    finalize()
    return results


if __name__ == "__main__":
    main()
