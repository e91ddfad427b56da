"""Render the gt and the predicted 128/256/N-point clouds of a trained
category to PNG comparisons (counterpart of ``fenet/cli/render.py``; the
reference's shapenet_img.py): the same flags, plus ``--device``.

    python -m fenet_torch.cli.render --category 02828884 \\
        --model out/%s/checkpoints/ --splits_path data/splits \\
        --data_dir_imgs ... --data_dir_pcl ... --out_dir renders/

Weights come from ``{--model % category}/model_best.pth.tar`` (or fenet's
``model_best.ckpt``); ``--deploy``
folds them first (``models.generator.to_deploy``). Writes
``{category}_{i:03d}.png`` for the first ``--n_samples`` val samples.
"""

from __future__ import annotations

import argparse
import os

import torch

from fenet_torch.cli.common import require_checkpoints
from fenet_torch.data.loader import DataLoader
from fenet_torch.data.shapenet import ShapeNetDataset, load_split
from fenet_torch.models.convert import load_reference_checkpoint
from fenet_torch.models.generator import Generator, to_deploy
from fenet_torch.utils.device import full_fp32, resolve_device
from fenet_torch.viz.render import render_clouds


def load_generator(parser, opt, ckpt_id: str, device) -> Generator:
    """The branched Generator of ``opt``'s architecture on ``device``, in
    eval mode, with the weights of ``{opt.model % ckpt_id}/model_best.pth.tar``
    or fenet's ``model_best.ckpt`` (a missing file is a usage error)."""
    path = require_checkpoints(parser, opt.model, [ckpt_id])[ckpt_id]
    with torch.device(device):
        gen = Generator(num_points=opt.num_points, backbone=opt.backbone,
                        fine_width=opt.fine_width, mid_width=opt.mid_width)
    return load_reference_checkpoint(gen, path).eval()


def add_model_args(parser: argparse.ArgumentParser) -> None:
    """The model flags the render and heatmap CLIs share with fenet's."""
    parser.add_argument("--num_points", type=int, default=1024)
    parser.add_argument("--model", type=str, default="./output/fenet/%s/checkpoints/")
    parser.add_argument("--backbone", type=str, default="RepVGG-A2")
    parser.add_argument("--fine_width", type=int, default=512,
                        help="decoder fine-head per-point channels")
    parser.add_argument("--mid_width", type=int, default=128,
                        help="decoder mid-head per-point channels")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device ('cpu' runs on the host)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--category", type=str, required=True)
    add_model_args(parser)
    parser.add_argument("--splits_path", type=str, default="./data/splits/")
    parser.add_argument("--data_dir_imgs", type=str,
                        default="./data/shapenet/ShapeNetRendering/")
    parser.add_argument("--data_dir_pcl", type=str,
                        default="./data/shapenet/ShapeNet_pointclouds/")
    parser.add_argument("--out_dir", type=str, default="./renders/")
    parser.add_argument("--n_samples", type=int, default=8)
    parser.add_argument("--deploy", action="store_true",
                        help="fold BN and the RepVGG branches (float32) before "
                             "inference")
    opt = parser.parse_args(argv)
    device = resolve_device(opt.device)
    full_fp32()
    gen = load_generator(parser, opt, opt.category, device)
    if opt.deploy:
        gen = to_deploy(gen)

    val_models = load_split(opt.splits_path, "val_models.json")
    ds = ShapeNetDataset(opt.data_dir_imgs, opt.data_dir_pcl, val_models,
                         [opt.category], opt.num_points, check_exists=True)
    loader = DataLoader(ds, 1, prefetch=0)
    os.makedirs(opt.out_dir, exist_ok=True)
    for i, batch in enumerate(loader):
        if i >= opt.n_samples:
            break
        with torch.inference_mode():
            pc1, pc2, pc3 = gen(torch.as_tensor(batch["image"]).to(device))
        render_clouds(
            {"gt": batch["points"][0], "pred_128": pc1[0], "pred_256": pc2[0],
             f"pred_{opt.num_points}": pc3[0]},
            path=os.path.join(opt.out_dir, f"{opt.category}_{i:03d}.png"),
            image=batch["image"][0],
        )
    print(f"wrote {min(opt.n_samples, len(ds))} renders to {opt.out_dir}")


if __name__ == "__main__":
    main()
