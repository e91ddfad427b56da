"""Device selection shared by the port's entry points."""

from __future__ import annotations

import torch
import torch.distributed


def resolve_device(device="cuda") -> torch.device:
    """The entry points' device: ``cuda`` unless the caller asks for another.

    A CUDA device on a machine without a card raises; the port never
    continues on the CPU unless the caller asked for it. In a process of a
    multi-process run, ``cuda`` without an index is the rank's card,
    ``cuda:(local_rank % device_count)``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    if device.type == "cuda" and device.index is None and torch.distributed.is_initialized():
        from fenet_torch.parallel.distributed import local_rank

        device = torch.device("cuda", local_rank() % torch.cuda.device_count())
    return device


def full_fp32() -> None:
    """Keep float32 matmuls and convolutions in full float32 on the card.

    cuDNN runs float32 convolutions in TF32 unless told otherwise, which
    keeps about three decimal digits; the eval path and its parity tests
    assume IEEE float32 throughout.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
