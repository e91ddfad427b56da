"""Structured training config with the reference's CLI defaults
(counterpart of ``fenet/train/config.py``): the same fields and defaults,
except ``ckpt_format``, whose default is the reference's ``.pth.tar``
container ("torch"); fenet's "flax" and "orbax" containers are written
on request (``train.checkpoint``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass
class TrainConfig:
    # the reference train.py's defaults
    category: str = ""
    batch_size: int = 128
    workers: int = 0
    nepoch: int = 50
    start_epoch: int = 0
    lr: float = 5e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    resume: bool = False
    lambda_cd: float = 100.0
    lambda_emd: float = 100.0
    train_save_freq: int = 20
    num_points: int = 1024
    dir_path: str = "./output/fenet/"
    splits_path: str = "./data/splits/"
    data_dir_imgs: str = "./data/shapenet/ShapeNetRendering/"
    data_dir_pcl: str = "./data/shapenet/ShapeNet_pointclouds/"
    manual_seed: Optional[int] = None

    # model
    backbone: str = "RepVGG-A2"
    pretrained_backbone: Optional[str] = None  # RepVGG-A2-train.pth path
    # per-point channel widths of the decoder's fine/mid heads (the
    # reference's 512/128; smaller values give a structure-identical
    # generator for fast tests)
    fine_width: int = 512
    mid_width: int = 128

    # EMD operator settings
    emd_eps: float = 0.05
    emd_iters: int = 3000
    # >1: eps-scaling phases in the training auction; 1 = the reference's
    # fixed-eps auction (the default)
    emd_scale_phases: int = 1
    # >0 gates the scaling phases per batch element on nearest-neighbour
    # competition (see fenet_torch.ops.emd); only read when phases > 1
    emd_scale_thresh: float = 0.3
    # False runs every auction iteration, as the reference driver does
    emd_early_exit: bool = True
    # 'auction' (the reference's, default) or 'sinkhorn' (entropic OT with
    # the detached-plan gradient)
    emd_impl: str = "auction"
    sinkhorn_blur: float = 0.01  # final entropic eps = blur**2
    sinkhorn_iters: int = 300
    # sync-BN on multi-rank runs: BatchNorm over the global batch (False:
    # each rank's own batch, the torch-DDP default)
    sync_bn: bool = True

    # validation epochs
    validate_epochs: Sequence[int] = (10, 30, 50)
    # checkpoint container: 'torch' = the reference's .pth.tar, 'flax' =
    # fenet's .ckpt, 'orbax' = fenet's .orbax directory (both with a JSON
    # sidecar)
    ckpt_format: str = "torch"
    # eval-time ICP and EMD settings
    eval_icp_iterations: int = 1024
    eval_icp_tolerance: float = 1e-10
    eval_emd_iters: int = 50
    eval_emd_eps: float = 0.005

    # finetune projection loss (loss_mode='finetune')
    grid_h: int = 64
    grid_w: int = 64
    sigma_sq: float = 2.0
    output_pcl_size: int = 1024
    lambda_bce: float = 100.0
    proj_squash: bool = False

    # parallelism: one process a rank, data_parallel x model_parallel ranks
    # (data_parallel 1: the world size over model_parallel)
    data_parallel: int = 1
    model_parallel: int = 1
