"""ShapeNet (R2N2 renderings) dataset (counterpart of
``fenet/data/shapenet.py``).

Index = model x 24 views; image ``{imgs}/{model}/rendering/{NN}.png`` cropped
``[4:-5, 4:-5, :3]``, BGR->RGB, raw 0..255 values without normalisation;
GT cloud ``{pcl}/{model}/pointcloud_{N}.npy``. Images are returned HWC.
A sample is read by ``__getitem__`` (OpenCV, imported only where an image is
read); a whole batch by ``load_batch`` through the native loader
(:mod:`fenet_torch.native`), which gives the same bytes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from fenet_torch import native

NUM_VIEWS = 24
HEIGHT = 128
WIDTH = 128

# The reference's 13 ShapeNet category ids.
SHAPENET_CATEGORIES: Dict[str, str] = {
    "airplane": "02691156",
    "bench": "02828884",
    "cabinet": "02933112",
    "car": "02958343",
    "lamp": "03636649",
    "monitor": "03211117",
    "rifle": "04090263",
    "sofa": "04256520",
    "speaker": "03691459",
    "table": "04379243",
    "telephone": "04401088",
    "vessel": "04530566",
    "chair": "03001627",
}


def _imread_rgb(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def load_split(splits_path: str, name: str) -> Dict[str, List[str]]:
    """Load train_models.json / val_models.json."""
    with open(os.path.join(splits_path, name)) as f:
        return json.load(f)


class ShapeNetDataset:
    def __init__(
        self,
        data_dir_imgs: str,
        data_dir_pcl: str,
        models: Dict[str, Sequence[str]],
        cats: Sequence[str],
        num_points: int = 1024,
        variety: bool = False,
        multi_resolution: bool = False,
        check_exists: bool = False,
        transform=None,
        image_dtype: str = "float32",
    ):
        """``image_dtype='uint8'`` returns raw uint8 pixels instead of float32,
        the same values at a quarter of the bytes; it needs
        ``transform=None``."""
        if image_dtype not in ("float32", "uint8"):
            raise ValueError(f"image_dtype must be float32|uint8, got {image_dtype}")
        if image_dtype == "uint8" and transform is not None:
            raise ValueError("image_dtype='uint8' requires transform=None")
        self.data_dir_imgs = data_dir_imgs
        self.data_dir_pcl = data_dir_pcl
        self.num_points = num_points
        self.variety = variety
        self.multi_resolution = multi_resolution
        self.transform = transform
        self.image_dtype = np.dtype(image_dtype)
        self.modelnames: List[str] = []
        self._meta_cache: Dict[str, np.ndarray] = {}  # model -> rendering metadata
        for cat in cats:
            for filename in models[cat]:
                if check_exists:
                    pcl = os.path.join(data_dir_pcl, filename,
                                       f"pointcloud_{num_points}.npy")
                    img = os.path.join(data_dir_imgs, filename, "rendering", "00.png")
                    if not (os.path.exists(pcl) and os.path.exists(img)):
                        continue
                self.modelnames.extend([filename] * NUM_VIEWS)

    def __len__(self) -> int:
        return len(self.modelnames)

    def _load_image(self, model: str, view: int) -> np.ndarray:
        path = os.path.join(self.data_dir_imgs, model, "rendering", f"{view:02d}.png")
        image = _imread_rgb(path)[4:-5, 4:-5, :3]
        if self.transform is not None:
            image = self.transform(image)
        return np.ascontiguousarray(image, self.image_dtype)

    def _load_pcl(self, model: str, n: int) -> np.ndarray:
        return np.load(
            os.path.join(self.data_dir_pcl, model, f"pointcloud_{n}.npy")
        ).astype(np.float32)

    def _render_path(self, index: int) -> str:
        return os.path.join(self.data_dir_imgs, self.modelnames[index], "rendering",
                            f"{index % NUM_VIEWS:02d}.png")

    def _pcl_paths(self, indices, n: int) -> List[str]:
        return [os.path.join(self.data_dir_pcl, self.modelnames[i], f"pointcloud_{n}.npy")
                for i in indices]

    def load_batch(self, indices):
        """The samples ``indices`` as one batch dict, read by the native
        loader; the same arrays as ``_collate`` of ``__getitem__``. Returns
        None, so that DataLoader falls back to the per-item path and its
        errors, where the native path cannot serve: a transform, a library
        that cannot be built, renders that are not 137 px, a missing or
        unreadable file."""
        if self.transform is not None:
            return None
        try:  # RuntimeError: no library; IOError: a file it cannot read
            out = {"image": native.load_images([self._render_path(i) for i in indices],
                                               dtype=self.image_dtype),
                   "points": native.load_clouds(self._pcl_paths(indices, self.num_points),
                                                self.num_points)}
            if self.multi_resolution:
                for n in (128, 256):
                    out[f"points_{n}"] = native.load_clouds(self._pcl_paths(indices, n), n)
        except (IOError, RuntimeError):
            return None
        if self.variety:
            xang, yang = [], []
            for i in indices:
                meta = self._metadata(self.modelnames[i])
                xang.append(np.pi / 180.0 * meta[i % NUM_VIEWS][0])
                yang.append(np.pi / 180.0 * meta[i % NUM_VIEWS][1])
            out["xangle"] = np.asarray(xang, np.float32)
            out["yangle"] = np.asarray(yang, np.float32)
        return out

    def _metadata(self, model: str) -> np.ndarray:
        """A model's rendering_metadata.txt, read once."""
        if model not in self._meta_cache:
            self._meta_cache[model] = np.loadtxt(os.path.join(
                self.data_dir_imgs, model, "rendering", "rendering_metadata.txt"))
        return self._meta_cache[model]

    def __getitem__(self, index: int):
        model = self.modelnames[index]
        view = index % NUM_VIEWS
        out = {"image": self._load_image(model, view)}
        if self.multi_resolution:
            out["points_128"] = self._load_pcl(model, 128)
            out["points_256"] = self._load_pcl(model, 256)
        out["points"] = self._load_pcl(model, self.num_points)
        if self.variety:
            meta = np.loadtxt(os.path.join(self.data_dir_imgs, model, "rendering",
                                           "rendering_metadata.txt"))
            out["xangle"] = np.float32(np.pi / 180.0 * meta[view][0])
            out["yangle"] = np.float32(np.pi / 180.0 * meta[view][1])
        return out
