"""Pix3D real-image dataset (counterpart of ``fenet/data/pix3d.py``).

Entries of ``pix3d.json`` are kept for the category whose
``pointclouds/.../pcl_{N}.npy`` exists; each sample is the image times its
mask, cropped to the bbox, resized keeping its aspect to HEIGHT - PAD and
zero-padded to 128x128 (HWC float32, raw 0..255), and the GT cloud rotated
twice by -90 degrees. Needs OpenCV, imported only where an image is read.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from fenet_torch.geometry.pointcloud import rotate

HEIGHT = 128
WIDTH = 128
PAD = 35


class Pix3DDataset:
    def __init__(self, data_dir: str, models: Optional[list] = None, category: str = "chair",
                 num_points: int = 1024, save: bool = False):
        if models is None:
            with open(os.path.join(data_dir, "pix3d.json")) as f:
                models = json.load(f)
        self.data_dir = data_dir
        self.category = category
        self.num_points = num_points
        self.save = save
        self.imgpaths: List[str] = []
        self.maskpaths: List[str] = []
        self.pclpaths: List[str] = []
        self.bbox: List[list] = []
        pcl = f"pcl_{num_points}"
        for model in models:
            if model["category"] != category:
                continue
            # model/[cat]/[name]/model.obj -> model/[cat]/[name]/pcl_N.npy,
            # by the reference's chain of replaces.
            modelpath = model["model"].replace("model", pcl)
            modelpath = modelpath.replace(pcl, "model", 1)
            modelpath = modelpath.replace("obj", "npy")
            pcl_path = os.path.join(data_dir, "pointclouds", modelpath)
            if os.path.exists(pcl_path):
                self.imgpaths.append(model["img"])
                self.maskpaths.append(model["mask"])
                self.pclpaths.append(pcl_path)
                self.bbox.append(model["bbox"])

    def __len__(self) -> int:
        return len(self.imgpaths)

    def __getitem__(self, index: int):
        import cv2

        img_path = os.path.join(self.data_dir, self.imgpaths[index])
        mask_path = os.path.join(self.data_dir, self.maskpaths[index])
        image = cv2.cvtColor(cv2.imread(img_path), cv2.COLOR_BGR2RGB)
        mask = cv2.imread(mask_path)
        if mask.shape[:2] != image.shape[:2]:
            mask = cv2.resize(mask, (image.shape[1], image.shape[0]))
        # The reference's uint8 product, kept: masks load as 0/255, so where
        # the mask is 255 the product wraps modulo 256 (255·x -> 256 - x)
        # instead of selecting the foreground. Trained reference weights saw
        # these images; a boolean select would break eval parity.
        image = image * mask
        x0, y0, x1, y1 = self.bbox[index]
        image = image[y0:y1, x0:x1, :]
        ratio = float(HEIGHT - PAD) / max(image.shape[:2])
        new_size = tuple(int(s * ratio) for s in image.shape[:2])
        image = cv2.resize(image, (new_size[1], new_size[0]))
        dh, dw = HEIGHT - new_size[0], WIDTH - new_size[1]
        image = cv2.copyMakeBorder(image, dh // 2, dh - dh // 2, dw // 2, dw - dw // 2,
                                   cv2.BORDER_CONSTANT, value=[0, 0, 0])
        angle = np.pi / 180.0 * -90
        pcl_gt = rotate(rotate(np.load(self.pclpaths[index]), angle, angle),
                        angle).astype(np.float32)
        out = {"image": np.ascontiguousarray(image, np.float32), "points": pcl_gt}
        if self.save:
            out["name"] = img_path[-8:-4]
        return out
