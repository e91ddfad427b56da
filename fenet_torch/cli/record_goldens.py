"""The 13-category CD/EMD golden table (counterpart of
``fenet/cli/record_goldens.py``): the same flags, defaults, settings block,
JSON schema, skip notes and summary line, plus ``--device``.

Given ShapeNet data and per-category checkpoints, the reference's
``.pth.tar`` files (testnet.py:112-136 loads one a category) or the port's
own, this writes the per-category CD and EMD table as JSON, to diff against
the reference's published numbers or against a table from its testnet.py
on the same checkpoints.

Defaults are the strict parity mode: full-budget ICP (no stall patience and,
with ``--icp_patience 0``, no relative plateau exit), the reference eval EMD
(eps 0.005, 50 iterations), metrics x100 (utils/metrics.py:46-58).

    # reference checkpoints; a pattern without %s is one file for all:
    python -m fenet_torch.cli.record_goldens \\
        --torch_model /ckpts/%s/model_best.pth.tar \\
        --data_dir_imgs .../ShapeNetRendering/ \\
        --data_dir_pcl .../ShapeNet_pointclouds/ \\
        --splits_path .../splits/ --out goldens_shapenet.json

    # the port's or fenet's checkpoints ({--model % cat}/model_best.pth.tar,
    # else model_best.ckpt, else model_best.orbax):
    python -m fenet_torch.cli.record_goldens \\
        --model ./output/fenet/%s/checkpoints/ --out goldens_shapenet.json

A category whose checkpoint or data are missing is skipped with a note in
the JSON, so a partial tree still gives a table. Under several processes
each evaluates its shard; the skip decision is gathered first, so that every
process skips the same categories, and rank 0 alone writes ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from fenet_torch.cli.eval_shapenet import ALL_CATS
from fenet_torch.data.loader import DataLoader
from fenet_torch.data.shapenet import ShapeNetDataset, load_split
from fenet_torch.eval.runner import evaluate_dataset
from fenet_torch.models.convert import load_reference_checkpoint
from fenet_torch.models.generator import Generator
from fenet_torch.parallel.distributed import (
    finalize,
    initialize,
    is_primary,
    shard_for_process,
    world_size,
)
from fenet_torch.train.checkpoint import BEST, best_checkpoint
from fenet_torch.utils.device import resolve_device


def checkpoint_path(opt, cat: str) -> str:
    """``--torch_model`` (``%s`` = category, or one file for every
    category) if given, else ``{--model % cat}/model_best.pth.tar`` or,
    where there is none, fenet's ``model_best.ckpt`` or ``model_best.orbax``;
    a missing checkpoint raises
    FileNotFoundError."""
    if opt.torch_model:
        path = opt.torch_model % cat if "%s" in opt.torch_model else opt.torch_model
    else:
        ckpt_dir = opt.model % cat if "%s" in opt.model else opt.model
        path = best_checkpoint(ckpt_dir) or os.path.join(ckpt_dir, BEST)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


def _agreed(err, device):
    """``err``, or a note if another process could not evaluate the
    category: ``evaluate_dataset`` is collective, so every process must
    make the same decision, or the others wait in its collective."""
    from fenet_torch.parallel.mesh import all_gather

    mine = torch.tensor([err is None], dtype=torch.int32,
                        device=device if device.type == "cuda" else "cpu")
    oks = all_gather(mine)
    if err is None and not all(bool(o.item()) for o in oks):
        return ("skipped: checkpoint/data missing on another process "
                "(collective consistency)")
    return err


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--batchSize", type=int, default=64)
    parser.add_argument("--num_points", type=int, default=1024)
    parser.add_argument("--model", type=str, default="./output/fenet/%s/checkpoints/",
                        help="the port's checkpoint dir pattern (%%s = category), "
                             "holding model_best.pth.tar or fenet's model_best.ckpt "
                             "or model_best.orbax")
    parser.add_argument("--torch_model", type=str, default=None,
                        help="reference .pth.tar pattern (%%s = category, else one "
                             "file for every category); takes precedence over "
                             "--model")
    parser.add_argument("--splits_path", type=str, default="./data/splits/")
    parser.add_argument("--data_dir_imgs", type=str,
                        default="./data/shapenet/ShapeNetRendering/")
    parser.add_argument("--data_dir_pcl", type=str,
                        default="./data/shapenet/ShapeNet_pointclouds/")
    parser.add_argument("--backbone", type=str, default="RepVGG-A2")
    parser.add_argument("--fine_width", type=int, default=512)
    parser.add_argument("--mid_width", type=int, default=128)
    parser.add_argument("--cats", nargs="*", default=ALL_CATS)
    parser.add_argument("--icp_iters", type=int, default=1024)
    parser.add_argument("--icp_patience", type=int, default=0,
                        help="0 = strict full-budget ICP (the golden default); "
                             "32 = the fast eval mode")
    parser.add_argument("--icp_rel_tolerance", type=float, default=None,
                        help="float32 plateau-exit threshold; default 0.0 (off) "
                             "when --icp_patience is 0, so the strict mode runs "
                             "the full budget, 1e-6 otherwise")
    parser.add_argument("--icp_coarse_points", type=int, default=0,
                        help="coarse-to-fine ICP warm start on this many "
                             "stride-subsampled points (0 = off)")
    parser.add_argument("--emd_iters", type=int, default=50)
    parser.add_argument("--split", type=str, default="val", choices=("val", "train"),
                        help="which split file to evaluate (testnet.py "
                             "evaluates val_models.json)")
    parser.add_argument("--out", type=str, default="goldens_shapenet.json")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; 'cpu' runs the plain PyTorch "
                             "versions of the kernels")
    opt = parser.parse_args(argv)
    if opt.icp_rel_tolerance is None:
        # The float32 plateau exit is a documented divergence from the
        # reference's full-budget host ICP (~0.1% of a metric); strict
        # goldens must not take it.
        opt.icp_rel_tolerance = 0.0 if opt.icp_patience == 0 else 1e-6
    initialize(device=opt.device)  # a no-op on a single process
    print(opt)
    device = resolve_device(opt.device)

    with torch.device(device):
        gen = Generator(num_points=opt.num_points, backbone=opt.backbone,
                        fine_width=opt.fine_width, mid_width=opt.mid_width)
    models = load_split(opt.splits_path, f"{opt.split}_models.json")
    table = {"settings": {
        "icp": {"iterations": opt.icp_iters, "tolerance": 1e-10,
                "rel_tolerance": opt.icp_rel_tolerance,
                "patience": opt.icp_patience,
                "coarse_points": opt.icp_coarse_points},
        "emd": {"eps": 0.005, "iters": opt.emd_iters},
        "metrics": "sqrt-EMD x100 / squared-CD x100 (utils/metrics.py)",
        "checkpoints": opt.torch_model or opt.model,
        "split": opt.split,
    }, "categories": {}}
    for cat in opt.cats:
        err = None
        try:
            load_reference_checkpoint(gen, checkpoint_path(opt, cat))
            ds = ShapeNetDataset(opt.data_dir_imgs, opt.data_dir_pcl, models, [cat],
                                 opt.num_points, multi_resolution=False, check_exists=True,
                                 image_dtype="uint8")
            if not len(ds):
                raise FileNotFoundError(f"no samples for {cat} under {opt.data_dir_imgs}")
        except FileNotFoundError as e:
            err = str(e)
        if world_size() > 1:
            err = _agreed(err, device)
        if err is not None:
            table["categories"][cat] = {"skipped": err}
            print(cat, "SKIPPED:", err)
            continue
        loader = DataLoader(shard_for_process(ds), opt.batchSize, drop_last=False)
        _, _, summary = evaluate_dataset(
            gen, loader, category=cat, logger=None, device=device,
            icp_iterations=opt.icp_iters, icp_patience=opt.icp_patience,
            icp_rel_tolerance=opt.icp_rel_tolerance,
            icp_coarse_points=opt.icp_coarse_points, emd_iters=opt.emd_iters,
        )
        table["categories"][cat] = {"cd": summary["ChamferDistance"],
                                    "emd": summary["EMD_distance"],
                                    "samples": summary["samples"]}
        print(cat, json.dumps(table["categories"][cat]))

    done = [c for c in table["categories"].values() if "cd" in c]
    if done:
        table["mean_cd"] = float(np.mean([c["cd"] for c in done]))
        table["mean_emd"] = float(np.mean([c["emd"] for c in done]))
    table["skipped"] = sorted(k for k, v in table["categories"].items() if "skipped" in v)
    if is_primary():  # one writer: the processes may share a file system
        with open(opt.out, "w") as f:
            json.dump(table, f, indent=1)
    print(json.dumps({"out": opt.out, "recorded": len(done),
                      "skipped": len(table["skipped"]),
                      "mean_cd": table.get("mean_cd"), "mean_emd": table.get("mean_emd")}))
    finalize()
    return table


if __name__ == "__main__":
    main()
