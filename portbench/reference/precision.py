"""Operand precision of the reference's products.

The reference computes in float32 with every operand of a convolution or a
matrix product kept whole. The controls round those operands first, as a
card does in a lower precision: TF32 keeps a 10-bit mantissa and adds in
float32 (the card's tensor cores with TF32 on), fp8 keeps e4m3 under one
scale a tensor. Rounding passes the gradient straight through, so a
backward multiplies by the rounded operands that the forward saved.
``exact_float32`` keeps the card's own TF32 switches off while the
reference runs, so that it computes in float32 whatever the program set.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("float32", "tf32", "fp8")
_FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.detach().float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & -0x2000  # nearest, ties to even
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    x = x.detach().float()
    scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Operands:
    """``ops(x)``: x as an operand of a product in ``mode``."""

    def __init__(self, mode: str = "float32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} is not one of {MODES}")
        self.mode = mode
        self._round = {"tf32": _tf32, "fp8": _fp8}.get(mode)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self._round is None:
            return x
        return x + (self._round(x) - x).detach()


FLOAT32 = Operands()


def tf32_switches() -> dict:
    """The process's switches that let the card compute float32 products
    in TF32 (True: on): cuDNN's convolutions, cuBLAS's matmuls, and the
    float32 matmul precision."""
    return {"cudnn.allow_tf32": bool(torch.backends.cudnn.allow_tf32),
            "cuda.matmul.allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
            "float32_matmul_precision": torch.get_float32_matmul_precision() != "highest"}


@contextlib.contextmanager
def exact_float32():
    """Every TF32 switch off while the block runs, whatever the program
    left set, and as it was after: the reference computes in float32."""
    cudnn, matmul = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.set_float32_matmul_precision(precision)
