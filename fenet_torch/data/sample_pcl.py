"""Offline ground-truth prep: ``pointcloud_128/256.npy`` per model by
farthest-point sampling (counterpart of ``fenet/data/sample_pcl.py``).

For each model, the 1024-point cloud is sorted by squared distance to a
viewpoint drawn from a fixed set of five, then 128 points (seed index 1)
and 256 points (seed index 0) are farthest-point sampled and saved next to
it. FPS runs on the caller's device: the card unless the caller asks for
the CPU. The files are the ones ``multi_resolution=True`` reads.
"""

from __future__ import annotations

import os
import random
from typing import Dict, Sequence

import numpy as np
import torch

from fenet_torch.ops.fps import farthest_point_sample, index_points
from fenet_torch.utils.device import resolve_device

# The reference's viewpoint set.
VIEWPOINTS = np.array(
    [[1, 0, 0], [0, 0, 1], [1, 0, 1], [-1, 0, 0], [-1, 1, 0]], np.float32
)


def sample_model_cloud(pcl: np.ndarray, rng: random.Random, device="cuda"):
    """(N, 3) float32 cloud -> (cloud_128, cloud_256), numpy float32; one
    draw of ``rng``."""
    viewpoint = VIEWPOINTS[rng.randrange(len(VIEWPOINTS))]
    order = np.argsort(((pcl - viewpoint) ** 2).sum(-1), kind="stable")
    centered = torch.as_tensor(pcl[order], device=device)[None]  # (1, N, 3)
    idx128 = farthest_point_sample(centered, 128, ran=False)
    idx256 = farthest_point_sample(centered, 256, ran=True)
    c128 = index_points(centered, idx128)[0].cpu().numpy()
    c256 = index_points(centered, idx256)[0].cpu().numpy()
    return c128, c256


def prepare_splits(
    data_dir_pcl: str,
    models: Dict[str, Sequence[str]],
    cats: Sequence[str],
    num_points: int = 1024,
    seed: int = 0,
    overwrite: bool = False,
    device="cuda",
) -> int:
    """Write the missing pointcloud_128/256.npy files (all of them with
    ``overwrite``); returns the number of models written. A skipped model
    draws nothing from the seeded viewpoint stream."""
    device = resolve_device(device)
    rng = random.Random(seed)
    written = 0
    for cat in cats:
        for model in models[cat]:
            mdir = os.path.join(data_dir_pcl, model)
            p128 = os.path.join(mdir, "pointcloud_128.npy")
            p256 = os.path.join(mdir, "pointcloud_256.npy")
            if not overwrite and os.path.exists(p128) and os.path.exists(p256):
                continue
            pcl = np.load(os.path.join(mdir, f"pointcloud_{num_points}.npy")).astype(np.float32)
            c128, c256 = sample_model_cloud(pcl, rng, device)
            np.save(p128, c128)
            np.save(p256, c256)
            written += 1
    return written
