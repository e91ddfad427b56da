"""The benchmark's inputs, made from the run's seed: images, clouds and PNG
bodies. Each stream of numbers has a generator of its own, seeded from the
run's seed and the stream's number, so one stream never shifts another."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

# Stream numbers.
WEIGHTS, IMAGES, CLOUDS, ORDER, KEEP = 0, 1, 2, 3, 4


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of run ``seed`` (any whole number)."""
    return (int(seed) * 0x9E3779B1 + stream * 0x85EBCA77) % (1 << 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def images(seed: int, count: int, hw: int, device) -> torch.Tensor:
    """(count, hw, hw, 3) uint8 pixels, uniform over 0..255."""
    return torch.randint(0, 256, (count, hw, hw, 3), generator=generator(seed, IMAGES, device),
                         device=device, dtype=torch.uint8)


def uniform_clouds(seed: int, count: int, points: int, device) -> torch.Tensor:
    """(count, points, 3) float32 uniform in [0, 0.9)^3, the evidence
    tools' training clouds."""
    return torch.rand((count, points, 3), generator=generator(seed, CLOUDS, device),
                      device=device) * 0.9


def blob_clouds(seed: int, count: int, points: int, device) -> torch.Tensor:
    """(count, points, 3) float32 object-like clouds, as the port's
    synthetic ShapeNet makes them: four gaussian clusters (sigma 0.08)
    about centres in [-0.3, 0.3]^3, clipped to [-0.45, 0.45]."""
    g = generator(seed, CLOUDS, device)
    centres = torch.rand((count, 4, 3), generator=g, device=device) * 0.6 - 0.3
    which = torch.randint(0, 4, (count, points), generator=g, device=device)
    noise = torch.randn((count, points, 3), generator=g, device=device) * 0.08
    pts = torch.gather(centres, 1, which[..., None].expand(-1, -1, 3)) + noise
    return pts.clamp(-0.45, 0.45)


def permutation(seed: int, n: int, stream: int = ORDER) -> np.ndarray:
    return torch.randperm(n, generator=generator(seed, stream, "cpu")).numpy()


def png(image: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 RGB image as PNG bytes (8-bit RGB, no filter)."""
    h, w, _ = image.shape
    raw = b"".join(b"\x00" + image[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))
