"""Data-prep CLI (counterpart of ``fenet/cli/prepare_data.py``): write
pointcloud_128/256.npy for every model in the splits by farthest-point
sampling, on ``--device`` (default the card).

    python -m fenet_torch.cli.prepare_data --splits_path data/splits/ \\
        --data_dir_pcl data/shapenet/ShapeNet_pointclouds/ [--device cpu]
"""

from __future__ import annotations

import argparse

from fenet_torch.data.sample_pcl import prepare_splits
from fenet_torch.data.shapenet import load_split
from fenet_torch.utils.device import resolve_device


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--splits_path", type=str, default="./data/splits/")
    parser.add_argument("--data_dir_pcl", type=str,
                        default="./data/shapenet/ShapeNet_pointclouds/")
    parser.add_argument("--num_points", type=int, default=1024)
    parser.add_argument("--splits", nargs="*",
                        default=["train_models.json", "val_models.json"])
    parser.add_argument("--cats", nargs="*", default=None)
    parser.add_argument("--overwrite", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device for FPS; 'cpu' runs it on the host")
    opt = parser.parse_args(argv)
    device = resolve_device(opt.device)

    total = 0
    for split in opt.splits:
        models = load_split(opt.splits_path, split)
        cats = opt.cats or list(models)
        total += prepare_splits(opt.data_dir_pcl, models, cats, opt.num_points,
                                overwrite=opt.overwrite, device=device)
    print(f"wrote FPS clouds for {total} models")
    return total


if __name__ == "__main__":
    main()
