"""Shared argparse plumbing with the reference drivers' flag names
(counterpart of ``fenet/cli/common.py``), plus ``--device``."""

from __future__ import annotations

import argparse
import os
from typing import Dict, Iterable

from fenet_torch.train.checkpoint import BEST, best_checkpoint
from fenet_torch.train.config import TrainConfig


def add_common_args(parser: argparse.ArgumentParser):
    """The reference train.py's flag set, names preserved, and fenet's
    extensions."""
    parser.add_argument("--category", type=str, default="", help="category")
    parser.add_argument("--batchSize", type=int, default=128,
                        help="input batch size")
    parser.add_argument("--momentum", type=float, default=0.9, metavar="M")
    parser.add_argument("--workers", type=int, default=0,
                        help="number of data loading workers")
    parser.add_argument("--nepoch", type=int, default=50)
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--lr", type=float, default=0.0005)
    parser.add_argument("--resume", type=bool, default=False)
    parser.add_argument("--lambda_cd", type=float, default=100.0)
    parser.add_argument("--lambda_emd", type=float, default=100.0)
    parser.add_argument("--train_save_freq", type=int, default=20)
    parser.add_argument("--num_points", type=int, default=1024,
                        help="number of points, [1024, 2048]")
    parser.add_argument("--dir_path", type=str, default="./output/fenet/")
    parser.add_argument("--splits_path", type=str, default="./data/splits/")
    parser.add_argument("--data_dir_imgs", type=str,
                        default="./data/shapenet/ShapeNetRendering/")
    parser.add_argument("--data_dir_pcl", type=str,
                        default="./data/shapenet/ShapeNet_pointclouds/")
    parser.add_argument("--backbone", type=str, default="RepVGG-A2")
    parser.add_argument("--pretrained_backbone", type=str, default=None)
    parser.add_argument("--fine_width", type=int, default=512,
                        help="decoder fine-head per-point channels "
                             "(reference: 512)")
    parser.add_argument("--mid_width", type=int, default=128,
                        help="decoder mid-head per-point channels "
                             "(reference: 128)")
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="ranks in the batch axis (1: the world size "
                             "over --model_parallel); one process a rank")
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="ranks that split the decoder's heads "
                             "(Megatron tensor parallelism)")
    parser.add_argument("--emd_iters", type=int, default=3000)
    parser.add_argument("--emd_eps", type=float, default=0.05)
    parser.add_argument("--emd_scale_phases", type=int, default=1,
                        help=">1 enables epsilon-scaling auction phases "
                             "(1 = the reference's fixed-eps auction, the "
                             "default). Recommended fast mode: 3")
    parser.add_argument("--emd_scale_thresh", type=float, default=0.3,
                        help=">0 gates the scaling phases on the NN-"
                             "competition fraction (0 = always on)")
    parser.add_argument("--emd_impl", type=str, default="auction",
                        choices=("auction", "sinkhorn"),
                        help="training EMD: 'auction' (reference "
                             "semantics, default) or 'sinkhorn' (entropic "
                             "OT with the same detached-plan gradient rule)")
    parser.add_argument("--sinkhorn_blur", type=float, default=0.01,
                        help="sinkhorn final entropic eps = blur^2 (the loop "
                             "anneals down to it)")
    parser.add_argument("--sinkhorn_iters", type=int, default=300)
    parser.add_argument("--sync_bn", type=int, default=1,
                        help="BatchNorm over the global batch on multi-rank "
                             "runs (0: each rank's own batch)")
    parser.add_argument("--validate_epochs", type=int, nargs="*",
                        default=[10, 30, 50],
                        help="epochs at which to validate + checkpoint "
                             "(reference: 10 30 50)")
    parser.add_argument("--ckpt_format", type=str, default="torch",
                        choices=("torch", "flax", "orbax"),
                        help="checkpoint container: 'torch', the reference's "
                             ".pth.tar (default), 'flax', fenet's .ckpt, or "
                             "'orbax', fenet's .orbax directory (both with "
                             "fenet's JSON sidecar)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    return parser


def config_from_args(opt) -> TrainConfig:
    return TrainConfig(
        category=opt.category,
        batch_size=opt.batchSize,
        workers=opt.workers,
        nepoch=opt.nepoch,
        start_epoch=opt.start_epoch,
        lr=opt.lr,
        momentum=opt.momentum,
        resume=opt.resume,
        lambda_cd=opt.lambda_cd,
        lambda_emd=opt.lambda_emd,
        train_save_freq=opt.train_save_freq,
        num_points=opt.num_points,
        dir_path=opt.dir_path,
        splits_path=opt.splits_path,
        data_dir_imgs=opt.data_dir_imgs,
        data_dir_pcl=opt.data_dir_pcl,
        backbone=opt.backbone,
        pretrained_backbone=opt.pretrained_backbone,
        fine_width=opt.fine_width,
        mid_width=opt.mid_width,
        data_parallel=opt.data_parallel,
        model_parallel=opt.model_parallel,
        emd_eps=opt.emd_eps,
        emd_iters=opt.emd_iters,
        emd_scale_phases=opt.emd_scale_phases,
        emd_scale_thresh=opt.emd_scale_thresh,
        emd_impl=opt.emd_impl,
        sinkhorn_blur=opt.sinkhorn_blur,
        sinkhorn_iters=opt.sinkhorn_iters,
        sync_bn=bool(opt.sync_bn),
        validate_epochs=tuple(opt.validate_epochs),
        ckpt_format=opt.ckpt_format,
    )


# The reference train.py's category list.
DEFAULT_TRAIN_CATS = ["02828884"]


def require_checkpoints(parser: argparse.ArgumentParser, pattern: str,
                        ids: Iterable[str]) -> Dict[str, str]:
    """``{id: {pattern % id}/model_best.pth.tar}``, or fenet's
    ``model_best.ckpt`` where there is no ``.pth.tar``, or its
    ``model_best.orbax`` where there is neither; a missing checkpoint is a
    usage error, raised before any data is read or any directory is made."""
    paths = {i: best_checkpoint(pattern % i) for i in ids}
    missing = [os.path.join(pattern % i, BEST) for i, p in paths.items() if p is None]
    if missing:
        parser.error(f"no checkpoint at {', '.join(missing)} (nor model_best.ckpt or "
                     "model_best.orbax); train "
                     "the category first or point --model at its checkpoint dir")
    return paths
