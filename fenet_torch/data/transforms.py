"""Host-side image augmentations on numpy HWC arrays (counterpart of
``fenet/data/transforms.py``): Compose, ToFloat, Normalize, CenterCrop,
RandomCrop, RandomFlip, ColorJitter, RandomNoise, SaltPepperNoise,
RandomBackground.

Each random transform draws from its own ``np.random.RandomState``, so two
transforms given identically seeded states make identical draws. The
outputs equal fenet's byte for byte, dtype included: the reader hands a
transform cv2's uint8 crop, and numpy's promotion is part of the result
(``Normalize`` of uint8 computes in float64, the crops stay uint8, the
noise and colour transforms return float32).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        for t in self.transforms:
            img = t(img)
        return img


class ToFloat:
    def __call__(self, img):
        return np.asarray(img, np.float32)


class Normalize:
    """(img/255 - mean) / std, per channel."""

    def __init__(self, mean, std):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, img):
        return (img / 255.0 - self.mean) / self.std


class CenterCrop:
    def __init__(self, height: int, width: int):
        self.h, self.w = height, width

    def __call__(self, img):
        h, w = img.shape[:2]
        y = max((h - self.h) // 2, 0)
        x = max((w - self.w) // 2, 0)
        return img[y : y + self.h, x : x + self.w]


class RandomCrop:
    def __init__(self, height: int, width: int, rng: Optional[np.random.RandomState] = None):
        self.h, self.w = height, width
        self.rng = rng or np.random.RandomState()

    def __call__(self, img):
        h, w = img.shape[:2]
        y = self.rng.randint(0, max(h - self.h, 0) + 1)
        x = self.rng.randint(0, max(w - self.w, 0) + 1)
        return img[y : y + self.h, x : x + self.w]


class RandomFlip:
    """A horizontal flip, then a vertical one, each with probability p."""

    def __init__(self, p: float = 0.5, rng=None):
        self.p = p
        self.rng = rng or np.random.RandomState()

    def __call__(self, img):
        if self.rng.rand() < self.p:
            img = img[:, ::-1]
        if self.rng.rand() < self.p:
            img = img[::-1, :]
        return np.ascontiguousarray(img)


class ColorJitter:
    """Brightness, contrast and saturation jitter, clipped to 0..255."""

    def __init__(self, brightness=0.4, contrast=0.4, saturation=0.4, rng=None):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.rng = rng or np.random.RandomState()

    def __call__(self, img):
        img = img.astype(np.float32)
        if self.brightness:
            img = img * (1 + self.rng.uniform(-self.brightness, self.brightness))
        if self.contrast:
            mean = img.mean()
            img = (img - mean) * (1 + self.rng.uniform(-self.contrast, self.contrast)) + mean
        if self.saturation:
            gray = img.mean(axis=2, keepdims=True)
            img = gray + (img - gray) * (
                1 + self.rng.uniform(-self.saturation, self.saturation))
        return np.clip(img, 0, 255)


class RandomNoise:
    """Additive gaussian noise, clipped to 0..255."""

    def __init__(self, std: float = 10.0, rng=None):
        self.std = std
        self.rng = rng or np.random.RandomState()

    def __call__(self, img):
        noise = self.rng.normal(0, self.std, img.shape).astype(np.float32)
        return np.clip(img + noise, 0, 255)


class SaltPepperNoise:
    """A share ``amount`` of pixels set to 0 or 255, half each."""

    def __init__(self, amount: float = 0.01, rng=None):
        self.amount = amount
        self.rng = rng or np.random.RandomState()

    def __call__(self, img):
        img = img.copy()
        mask = self.rng.rand(*img.shape[:2])
        img[mask < self.amount / 2] = 0.0
        img[mask > 1 - self.amount / 2] = 255.0
        return img


class RandomBackground:
    """Black (all-zero) background pixels replaced by one random solid
    colour drawn from ``color_range``."""

    def __init__(self, color_range=((225, 255), (225, 255), (225, 255)), rng=None):
        self.color_range = color_range
        self.rng = rng or np.random.RandomState()

    def __call__(self, img):
        color = np.array(
            [self.rng.randint(lo, hi + 1) for lo, hi in self.color_range], np.float32)
        bg = (img.sum(axis=2) == 0)[..., None]
        return np.where(bg, color, img)
