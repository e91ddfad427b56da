"""The network's input contract for serving (counterpart of
``fenet/utils/images.py``), shared by the predict CLI and the HTTP server so
that a change of policy cannot miss a consumer.
"""

from __future__ import annotations

import numpy as np


def normalize_rgb(img: np.ndarray) -> np.ndarray:
    """RGB HWC -> float32 128x128x3, raw 0..255 pixels as in training.

    ShapeNet renders are 137x137 and the datasets crop [4:-5, 4:-5]; a
    137x137 serving input gets the same crop, any other size a plain
    resize."""
    import cv2

    if img.shape[:2] == (137, 137):
        img = img[4:-5, 4:-5]
    elif img.shape[:2] != (128, 128):
        img = cv2.resize(img, (128, 128), interpolation=cv2.INTER_AREA)
    return img[:, :, :3].astype(np.float32)
