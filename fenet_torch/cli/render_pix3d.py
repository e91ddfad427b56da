"""Render gt and predicted clouds of Pix3D's real images (counterpart of
``fenet/cli/render_pix3d.py``; the reference's save_pix3d_img.py): the
same flags, plus ``--device``.

    python -m fenet_torch.cli.render_pix3d --data_dir data/pix3d/ \\
        --model out/%s/checkpoints/ --out_dir pix3d_renders/

Each Pix3D category is predicted with its ShapeNet category's weights,
``{--model % id}/model_best.pth.tar`` or ``model_best.ckpt``
(``eval_pix3d.PIX3D_TO_SHAPENET``),
and writes ``{out_dir}/{category}/{name}_gt.png`` and ``{name}_pr.png`` in
the reference's fixed frame (red points, ±0.45 axes, azim -45, elev
-165). A sample whose two files both exist is skipped, so a run cut
between the two saves writes the missing one again.
"""

from __future__ import annotations

import argparse
import os

import torch

from fenet_torch.cli.eval_pix3d import PIX3D_TO_SHAPENET
from fenet_torch.cli.render import add_model_args, load_generator
from fenet_torch.data.loader import DataLoader
from fenet_torch.data.pix3d import Pix3DDataset
from fenet_torch.utils.device import full_fp32, resolve_device
from fenet_torch.viz.render import save_pix3d_cloud_png


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(parser)
    parser.add_argument("--data_dir", type=str, default="./data/pix3d/")
    parser.add_argument("--cats", nargs="*", default=["sofa", "table", "chair"])
    parser.add_argument("--out_dir", type=str, default="./pix3d_renders/")
    parser.add_argument("--n_samples", type=int, default=8,
                        help="most renders a category (0 = all)")
    parser.add_argument("--scale", type=float, default=0.45)
    parser.add_argument("--azim", type=float, default=-45.0)
    parser.add_argument("--elev", type=float, default=-165.0)
    opt = parser.parse_args(argv)
    print(opt)
    device = resolve_device(opt.device)
    full_fp32()
    style = dict(scale=opt.scale, azim=opt.azim, elev=opt.elev)

    written = {}
    for cat in opt.cats:
        gen = load_generator(parser, opt, PIX3D_TO_SHAPENET[cat], device)
        ds = Pix3DDataset(opt.data_dir, category=cat, num_points=opt.num_points, save=True)
        out_dir = os.path.join(opt.out_dir, cat)
        os.makedirs(out_dir, exist_ok=True)
        count = 0
        for batch in DataLoader(ds, 1, prefetch=0):
            if opt.n_samples and count >= opt.n_samples:
                break
            name = batch["name"][0]
            gt_path = os.path.join(out_dir, f"{name}_gt.png")
            pr_path = os.path.join(out_dir, f"{name}_pr.png")
            if os.path.exists(gt_path) and os.path.exists(pr_path):
                continue
            with torch.inference_mode():
                _, _, pred = gen(torch.as_tensor(batch["image"]).to(device))
            save_pix3d_cloud_png(batch["points"][0], gt_path, **style)
            save_pix3d_cloud_png(pred[0], pr_path, **style)
            count += 1
        written[cat] = count
        print(f"{cat}: wrote {count} GT/pred pairs to {out_dir}")
    return written


if __name__ == "__main__":
    main()
