"""Images in, point clouds out, from a deploy checkpoint or artifact
(counterpart of ``fenet/cli/predict.py``): the same flags, plus
``--device``. One PLY per image; a pure forward, no metrics, so a bfloat16
export is usable here and in the server only.

    python -m fenet_torch.cli.predict --deploy_ckpt .../model_deploy.pt2 \\
        --images renders/ --out_dir predictions/

The last partial batch is padded to ``--batchSize``, so the forward sees
one shape; batch i is fetched only after batch i+1 is dispatched, so the
next batch's decode and upload overlap the current one's compute.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from fenet_torch.utils.images import normalize_rgb


def _load_image(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return normalize_rgb(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))


def _image_paths(spec: str):
    if os.path.isdir(spec):
        return sorted(p for ext in ("png", "jpg", "jpeg")
                      for p in glob.glob(os.path.join(spec, f"*.{ext}")))
    if os.path.isfile(spec):
        return [spec]
    return sorted(glob.glob(spec))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--deploy_ckpt", type=str, required=True,
                        help="folded checkpoint from fenet_torch.cli.export_deploy "
                             "(its sidecar gives the architecture and dtype), "
                             "fenet's model_deploy.ckpt, an orbax directory of "
                             "the same tree, or a *.pt2 artifact "
                             "(--format export)")
    parser.add_argument("--images", type=str, required=True,
                        help="image file, directory, or glob pattern")
    parser.add_argument("--out_dir", type=str, default="./predictions/")
    parser.add_argument("--batchSize", type=int, default=32)
    parser.add_argument("--ply_binary", action="store_true",
                        help="write binary little-endian PLY instead of ascii")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: 'cuda' serves over every visible card "
                             "(the batch rounded up to the card count and split), "
                             "'cuda:1' on that card alone, 'cpu' on the host")
    opt = parser.parse_args(argv)

    paths = _image_paths(opt.images)
    if not paths:
        raise FileNotFoundError(f"no images match {opt.images!r}")

    from fenet_torch.serve.batcher import fetch
    from fenet_torch.serve.server import build_forward
    from fenet_torch.utils.ply import export_pointcloud

    forward, meta = build_forward(opt.deploy_ckpt, opt.batchSize, opt.device)
    bs = meta["max_batch"]
    os.makedirs(opt.out_dir, exist_ok=True)
    written = []
    used_names = set()  # chair.png and chair.jpg must not share chair.ply

    def flush(chunk, out):
        for path, cloud in zip(chunk, fetch(out)):
            stem = os.path.splitext(os.path.basename(path))[0]
            name, k = stem + ".ply", 1
            while name in used_names:
                name, k = f"{stem}_{k}.ply", k + 1
            used_names.add(name)
            dst = os.path.join(opt.out_dir, name)
            export_pointcloud(cloud, dst, as_text=not opt.ply_binary)
            written.append(dst)

    pending = None
    for start in range(0, len(paths), bs):
        chunk = paths[start:start + bs]
        images = np.stack([_load_image(p) for p in chunk])
        if len(chunk) < bs:
            images = np.concatenate([images, images[-1:].repeat(bs - len(chunk), 0)])
        out = forward(images.astype(np.uint8))
        if pending is not None:
            flush(*pending)
        pending = (chunk, out)
    if pending is not None:
        flush(*pending)
    print(f"wrote {len(written)} clouds to {opt.out_dir} "
          f"(dtype={meta['dtype']}, n_points={meta['num_points']})")
    return written


if __name__ == "__main__":
    main()
