"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The entry points' device: ``cuda`` unless the caller asks for another.

    A CUDA device on a machine without a card raises; the port never
    continues on the CPU unless the caller asked for it.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return device


def full_fp32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 unless told otherwise, which
    keeps about three decimal digits; the eval path and its parity tests
    assume IEEE float32 throughout.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
