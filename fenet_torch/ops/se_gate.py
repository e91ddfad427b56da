"""RepVGG-D2se's squeeze-and-excite gate with a hand-written CUDA backward,
and its plain PyTorch version (counterpart of ``fenet/models/repvgg.py``'s
``SEBlock``, which XLA fuses; no Pallas kernel).

For x (B, C, h, w) and the gate's ``down`` (R, C) and ``up`` (C, R) linears:

    m = mean_hw x,  h = relu(down(m)),  s = sigmoid(up(h)),  y = x · s[b, c]

and from dy, with t = sum_hw dy·x, ds = t·(1 - s)·s, dz = (ds·up)·[h > 0]:

    dx = dy·s + (dz·down) / (h·w),  d_up = dsᵀh,  d_bu = Σ_b ds,
    d_down = dzᵀm,  d_bd = Σ_b dz

:func:`se_gate` is one ``torch.autograd.Function``. Its forward is
:func:`gate_forward`, PyTorch's operations on every device and in every
dtype, run without autograd's recording, so that y has PyTorch's bits by
construction (the training benchmark's reference runs PyTorch's ops, and its
first loss through the auction EMD moves with the last bit of any
activation). Its backward on the card is :func:`se_gate_kernel`, three
launches of ``csrc/se_gate.cu`` (a pass over dy and x, the excite's backward,
a pass that writes dx whose first blocks write the four parameter
gradients), which sum in another order than autograd, with no atomics, so
that a run repeats bit for bit; it takes float32 and raises on what it does
not take, with no fallback. On the CPU the backward is
:func:`gate_backward_plain`, the formulas of autograd's nodes for the
forward's operations. :func:`se_gate_kernel` counts its launches in
``se_gate_kernel.launches``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from fenet_torch.ops import _build

# Launches of this module's kernels a backward on the card (the forward
# launches none of them).
BACKWARD_LAUNCHES = 3


def gate_forward(x: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, wu: torch.Tensor,
                 bu: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gate in PyTorch's operations, on any device and dtype -> (y,
    means (B, C), hidden units after the ReLU (B, R), s (B, C))."""
    mean = x.mean(dim=(2, 3))
    hidden = torch.relu(F.linear(mean, wd, bd))
    gate = torch.sigmoid(F.linear(hidden, wu, bu))
    return x * gate[:, :, None, None], mean, hidden, gate


def gate_backward_plain(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
                        hidden: torch.Tensor, gate: torch.Tensor, wd: torch.Tensor,
                        wu: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gate's backward from the forward's saved tensors, with the
    operations of autograd's nodes for :func:`gate_forward` -> (dx,
    d_down.weight, d_down.bias, d_up.weight, d_up.bias)."""
    t = (dy * x).sum(dim=(2, 3))
    ds = torch.ops.aten.sigmoid_backward(t, gate)
    dz = torch.ops.aten.threshold_backward(ds.mm(wu), hidden, 0)
    shift = dz.mm(wd) / (x.shape[2] * x.shape[3])
    dx = dy * gate[:, :, None, None] + shift[:, :, None, None]
    return dx, dz.t().mm(mean), dz.sum(0), ds.t().mm(hidden), ds.sum(0)


def _check(named, kernel: str) -> None:
    """Raise ValueError unless every (name, tensor) is float32, contiguous
    and on the first one's CUDA device."""
    device = named[0][1].device
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"{kernel}: {name} has dtype {t.dtype}, needs float32")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, {named[0][0]} on {device}")
    if device.type != "cuda":
        raise ValueError(f"{kernel}: tensors on {device}, not a CUDA device")


def _dims(x: torch.Tensor, wd: torch.Tensor, wu: torch.Tensor) -> Tuple[int, int, int, int]:
    """(B, C, R, h·w), or ValueError unless x is (B, C, h, w) with no empty
    dimension and the weights are (R, C) and (C, R)."""
    if x.dim() != 4 or 0 in x.shape:
        raise ValueError(f"se_gate: x has shape {tuple(x.shape)}, needs (B, C, h, w) > 0")
    b, c, h, w = x.shape
    r = wd.shape[0] if wd.dim() == 2 else 0
    if r == 0 or tuple(wd.shape) != (r, c) or tuple(wu.shape) != (c, r):
        raise ValueError(f"se_gate: weights {tuple(wd.shape)} and {tuple(wu.shape)} do not "
                         f"gate {c} channels")
    return b, c, r, h * w


def _launches(device: torch.device, *calls) -> None:
    """Call each (symbol, *args) of the gate's library in turn on
    ``device``'s current stream; tensors pass as their addresses. Raises on
    a launch that returned a CUDA error."""
    lib = _build.library("se_gate")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for symbol, *args in calls:
            status = getattr(lib, symbol)(
                *(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), stream)
            _build.check(status, f"se_gate ({symbol})")


def se_gate_kernel(dy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor, hidden: torch.Tensor,
                   gate: torch.Tensor, wd: torch.Tensor,
                   wu: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The gate's backward on the card in ``BACKWARD_LAUNCHES`` launches,
    from :func:`gate_forward`'s saved tensors -> (dx, d_down.weight,
    d_down.bias, d_up.weight, d_up.bias). Every tensor float32, contiguous,
    on one CUDA device; x and dy (B, C, h, w), the means and s (B, C), the
    hidden units (B, R), wd (R, C), wu (C, R). No host sync. Adds its
    launches to ``se_gate_kernel.launches``."""
    b, c, r, hw = _dims(x, wd, wu)
    if dy.shape != x.shape or mean.shape != (b, c) or gate.shape != (b, c) \
            or hidden.shape != (b, r):
        raise ValueError(f"se_gate backward: dy {tuple(dy.shape)}, means {tuple(mean.shape)}, "
                         f"hidden {tuple(hidden.shape)}, s {tuple(gate.shape)} for x "
                         f"{tuple(x.shape)}")
    _check((("dy", dy), ("x", x), ("means", mean), ("hidden", hidden), ("s", gate),
            ("down.weight", wd), ("up.weight", wu)), "se_gate backward")
    scratch = torch.empty(b * (3 * c + r), dtype=torch.float32, device=x.device)
    t, ds, shift = (scratch[k * b * c:(k + 1) * b * c] for k in range(3))
    dz = scratch[3 * b * c:]
    dx = torch.empty_like(dy)
    dwd, dbd = torch.empty_like(wd), wd.new_empty(r)
    dwu, dbu = torch.empty_like(wu), wu.new_empty(c)
    _launches(x.device,
              ("fenet_se_squeeze", dy, x, t, b * c, hw),
              ("fenet_se_excite_backward", t, gate, hidden, wd, wu, ds, dz, shift, b, c, r, hw),
              ("fenet_se_scale", dy, gate, shift, dx, b, c, r, hw, ds, dz, hidden, mean, dwd, dbd,
               dwu, dbu))
    se_gate_kernel.launches += BACKWARD_LAUNCHES
    return dx, dwd, dbd, dwu, dbu


se_gate_kernel.launches = 0


class _Gate(torch.autograd.Function):
    """The gate with its own backward; saves x, the means, the hidden units
    after the ReLU and s, and the two weights."""

    @staticmethod
    def forward(ctx, x, wd, bd, wu, bu):
        y, mean, hidden, gate = gate_forward(x, wd, bd, wu, bu)
        ctx.save_for_backward(x, mean, hidden, gate, wd, wu)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        backward = se_gate_kernel if dy.is_cuda else gate_backward_plain
        return backward(dy.contiguous(), *ctx.saved_tensors)


def se_gate(x: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor, wu: torch.Tensor,
            bu: torch.Tensor) -> torch.Tensor:
    """x (B, C, h, w) scaled channel by channel by sigmoid(up(relu(down(
    mean_hw x)))), ``down`` = (wd, bd) and ``up`` = (wu, bu); differentiable
    in all five. PyTorch's operations forward; backward the kernels for
    CUDA tensors, the plain formulas for CPU ones."""
    return _Gate.apply(x, wd, bd, wu, bu)
