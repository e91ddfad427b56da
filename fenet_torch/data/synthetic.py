"""Synthetic ShapeNet- and Pix3D-shaped data for tests and the card smoke
run (counterpart of ``fenet/data/synthetic.py``): the same seeds give the
same arrays and files as the JAX package's generator.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from fenet_torch.data.shapenet import NUM_VIEWS


def _random_cloud(rng, n: int) -> np.ndarray:
    """A vaguely object-like blob: a few gaussian clusters in [-0.4, 0.4]^3."""
    centers = rng.uniform(-0.3, 0.3, size=(4, 3))
    pts = centers[rng.randint(0, 4, n)] + rng.normal(0, 0.08, (n, 3))
    return np.clip(pts, -0.45, 0.45).astype(np.float32)


class SyntheticShapeNet:
    """In-memory stand-in with the ShapeNetDataset sample dict schema."""

    def __init__(self, n_models: int = 4, num_points: int = 1024,
                 variety: bool = False, multi_resolution: bool = False,
                 seed: int = 0, image_hw: int = 128):
        rng = np.random.RandomState(seed)
        self.num_points = num_points
        self.variety = variety
        self.multi_resolution = multi_resolution
        self.image_hw = image_hw
        self.clouds = [_random_cloud(rng, num_points) for _ in range(n_models)]
        self.small = {
            n: [c[rng.choice(num_points, n, replace=False)] for c in self.clouds]
            for n in (128, 256)
        }
        self.images = [
            rng.randint(0, 255, (image_hw, image_hw, 3)).astype(np.float32)
            for _ in range(n_models)
        ]
        self.angles = rng.uniform(-np.pi, np.pi, size=(n_models, NUM_VIEWS, 2))

    def __len__(self):
        return len(self.clouds) * NUM_VIEWS

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        model = index // NUM_VIEWS
        view = index % NUM_VIEWS
        out = {"image": self.images[model], "points": self.clouds[model]}
        if self.multi_resolution:
            out["points_128"] = self.small[128][model]
            out["points_256"] = self.small[256][model]
        if self.variety:
            out["xangle"] = np.float32(self.angles[model, view, 0])
            out["yangle"] = np.float32(self.angles[model, view, 1])
        return out


def write_synthetic_shapenet(root: str, cats: Sequence[str] = ("02691156",),
                             models_per_cat: int = 2, num_points: int = 1024,
                             seed: int = 0) -> Dict[str, List[str]]:
    """Write a reference-layout tree:

    {root}/ShapeNetRendering/{cat}/{model}/rendering/NN.png (+metadata)
    {root}/ShapeNet_pointclouds/{cat}/{model}/pointcloud_{128,256,N}.npy
    {root}/splits/{train,val}_models.json

    Returns the split dict {cat: [relative model paths]}. Needs OpenCV.
    """
    import cv2

    rng = np.random.RandomState(seed)
    splits: Dict[str, List[str]] = {}
    img_root = os.path.join(root, "ShapeNetRendering")
    pcl_root = os.path.join(root, "ShapeNet_pointclouds")
    for cat in cats:
        splits[cat] = []
        for m in range(models_per_cat):
            rel = f"{cat}/model_{m:04d}"
            splits[cat].append(rel)
            rdir = os.path.join(img_root, rel, "rendering")
            os.makedirs(rdir, exist_ok=True)
            meta = []
            for v in range(NUM_VIEWS):
                img = rng.randint(0, 255, (137, 137, 3), np.uint8)
                cv2.imwrite(os.path.join(rdir, f"{v:02d}.png"), img)
                meta.append([rng.uniform(0, 360), rng.uniform(20, 30), 0,
                             rng.uniform(0.6, 0.8), 25])
            np.savetxt(os.path.join(rdir, "rendering_metadata.txt"), np.asarray(meta))
            pdir = os.path.join(pcl_root, rel)
            os.makedirs(pdir, exist_ok=True)
            cloud = _random_cloud(rng, num_points)
            np.save(os.path.join(pdir, f"pointcloud_{num_points}.npy"), cloud)
            for n in (128, 256):
                sub = cloud[rng.choice(num_points, n, replace=False)]
                np.save(os.path.join(pdir, f"pointcloud_{n}.npy"), sub)
    sdir = os.path.join(root, "splits")
    os.makedirs(sdir, exist_ok=True)
    for name in ("train_models.json", "val_models.json"):
        with open(os.path.join(sdir, name), "w") as f:
            json.dump(splits, f)
    return splits


def write_synthetic_pix3d(root: str, cats: Sequence[str] = ("chair",), samples_per_cat: int = 2,
                          num_points: int = 1024, seed: int = 0) -> List[dict]:
    """Write a Pix3D-layout tree:

    {root}/pix3d.json                      entry list
    {root}/img/{cat}/NNNN.png              image
    {root}/mask/{cat}/NNNN.png             binary object mask (0/1)
    {root}/model/{cat}/{name}/model.obj    (path recorded only)
    {root}/pointclouds/model/{cat}/{name}/pcl_{N}.npy

    Returns the pix3d.json entry list. Needs OpenCV.
    """
    import cv2

    rng = np.random.RandomState(seed)
    entries = []
    for cat in cats:
        for s in range(samples_per_cat):
            name = f"synth_{cat}_{s:04d}"
            img_rel = f"img/{cat}/{s:04d}.png"
            mask_rel = f"mask/{cat}/{s:04d}.png"
            model_rel = f"model/{cat}/{name}/model.obj"
            h, w = int(rng.randint(160, 320)), int(rng.randint(160, 320))
            img = rng.randint(0, 255, (h, w, 3), np.uint8)
            mask = np.zeros((h, w, 3), np.uint8)
            x0, y0 = int(rng.randint(0, w // 4)), int(rng.randint(0, h // 4))
            x1 = int(rng.randint(3 * w // 4, w))
            y1 = int(rng.randint(3 * h // 4, h))
            mask[y0:y1, x0:x1] = 1
            for rel, arr in ((img_rel, img), (mask_rel, mask)):
                path = os.path.join(root, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                cv2.imwrite(path, arr)
            pcl_path = os.path.join(root, "pointclouds", "model", cat, name,
                                    f"pcl_{num_points}.npy")
            os.makedirs(os.path.dirname(pcl_path), exist_ok=True)
            np.save(pcl_path, _random_cloud(rng, num_points))
            entries.append({"category": cat, "img": img_rel, "mask": mask_rel,
                            "model": model_rel, "bbox": [x0, y0, x1, y1]})
    with open(os.path.join(root, "pix3d.json"), "w") as f:
        json.dump(entries, f)
    return entries
