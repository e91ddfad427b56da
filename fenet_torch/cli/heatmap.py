"""Grad-CAM heatmaps of a trained category (counterpart of
``fenet/cli/heatmap.py``; the reference's models/heatmap.py driver): the
same flags, plus ``--device``.

    python -m fenet_torch.cli.heatmap --category 02828884 \\
        --model out/%s/checkpoints/ --splits_path data/splits \\
        --data_dir_imgs ... --data_dir_pcl ... --layer stage3

Weights come from ``{--model % category}/model_best.pth.tar`` (or fenet's
``model_best.ckpt`` or ``model_best.orbax``). Writes
``{category}_{i:03d}_cam[_{layer}].png``, the CAM blended onto the input,
for the first ``--n_samples`` val samples.
"""

from __future__ import annotations

import argparse
import os

from fenet_torch.cli.render import add_model_args, load_generator
from fenet_torch.data.loader import DataLoader
from fenet_torch.data.shapenet import ShapeNetDataset, load_split
from fenet_torch.utils.device import full_fp32, resolve_device
from fenet_torch.viz.gradcam import save_cam_overlay


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
    parser.add_argument("--out_dir", type=str, default="./heatmaps/")
    parser.add_argument("--n_samples", type=int, default=4)
    parser.add_argument("--alpha", type=float, default=0.4)
    parser.add_argument("--layer", type=str, default=None,
                        help="backbone layer for the CAM: a block name "
                             "('stage2_3'), a stage prefix ('stage2' = that "
                             "stage's last block), or omitted for the final "
                             "feature map")
    opt = parser.parse_args(argv)
    device = resolve_device(opt.device)
    full_fp32()
    gen = load_generator(parser, opt, opt.category, device)
    if opt.layer is not None:
        gen.RepVGG.resolve_block(opt.layer)  # an unknown layer fails before any work

    val_models = load_split(opt.splits_path, "val_models.json")
    ds = ShapeNetDataset(opt.data_dir_imgs, opt.data_dir_pcl, val_models,
                         [opt.category], opt.num_points, check_exists=True)
    loader = DataLoader(ds, 1, prefetch=0)
    os.makedirs(opt.out_dir, exist_ok=True)
    suffix = f"_{opt.layer}" if opt.layer else ""
    for i, batch in enumerate(loader):
        if i >= opt.n_samples:
            break
        path = os.path.join(opt.out_dir, f"{opt.category}_{i:03d}_cam{suffix}.png")
        save_cam_overlay(gen, batch["image"], path, alpha=opt.alpha, layer=opt.layer)
    print(f"wrote {min(opt.n_samples, len(ds))} CAM overlays to {opt.out_dir}")


if __name__ == "__main__":
    main()
