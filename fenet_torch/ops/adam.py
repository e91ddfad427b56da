"""Adam's update as one hand-written CUDA pass, its plain PyTorch version,
and the optimizer that launches it (counterpart of fenet's optax
``chain(add_decayed_weights, scale_by_adam)``, which XLA fuses into fenet's
step; no Pallas kernel).

The update is torch's Adam with L2 decay added to the gradient (not AdamW):
with ``t`` the parameter's step after this one, ``bc1 = 1 - beta1**t`` and
``bc2 = 1 - beta2**t``,

    g' = g + weight_decay·p
    m  = lerp(m, g', 1 - beta1)
    v  = beta2·v + (1 - beta2)·g'²
    p -= (lr / bc1)·m / (√v / √bc2 + eps)

:func:`adam_kernel` launches ``csrc/adam.cu`` over many tensors at once (one
launch for up to ``MAX_TENSORS``), reading p, g, m and v once and writing p,
m and v once: 28 bytes a parameter, where torch's foreach path moves about
84. It follows the foreach path's operation order; :func:`adam_plain` is the
same arithmetic tensor by tensor in plain PyTorch, for the tests and
``chip_smoke.py``.

:class:`Adam` is ``torch.optim.Adam`` whose step launches the pass for CUDA
parameters; for CPU parameters it takes torch's own step as its plain path.
Its constructor, state and ``state_dict`` are torch's, so checkpoints move
between the two unchanged, and its step runs inside torch's
``Optimizer.step#Adam.step`` profiler range.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from fenet_torch.ops import _build

# Tensors one launch takes: the table in the kernel's parameter space
# (csrc/adam.cu: kMaxTensors).
MAX_TENSORS = 600
# Group options the pass does not compute; each must be off on the card.
_UNSUPPORTED = ("amsgrad", "maximize", "capturable", "differentiable", "fused",
                "decoupled_weight_decay")


def corrections(step: float, lr: float, beta1: float, beta2: float) -> Tuple[float, float]:
    """(-lr/bc1, √bc2) at step ``step``, in double, as torch's foreach Adam
    computes them; the kernel takes them rounded to float32, as torch's
    scalar lists are."""
    return (lr / (1 - beta1 ** step)) * -1, (1 - beta2 ** step) ** 0.5


@torch.no_grad()
def adam_plain(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               exp_avgs: Sequence[torch.Tensor], exp_avg_sqs: Sequence[torch.Tensor],
               steps: Sequence[float], *, lr: float, beta1: float, beta2: float, eps: float,
               weight_decay: float) -> None:
    """Plain version of :func:`adam_kernel`: the update of each tensor in
    place, with the foreach path's operations one tensor at a time."""
    for p, g, m, v, step in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        neg_step, bc2_sqrt = corrections(step, lr, beta1, beta2)
        if weight_decay != 0:
            g = g.add(p, alpha=weight_decay)
        m.lerp_(g, 1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        p.addcdiv_(m, v.sqrt().div_(bc2_sqrt).add_(eps), value=neg_step)


def _table(params, grads, exp_avgs, exp_avg_sqs) -> Tuple[torch.device, np.ndarray, np.ndarray]:
    """The launch table, checked: the device, the (param, grad, exp_avg,
    exp_avg_sq) addresses as (count, 4) uint64 and the sizes as (count,)
    int64. Raises ValueError unless every tensor is float32, contiguous, of
    its param's size and on one CUDA device."""
    quads = list(zip(params, grads, exp_avgs, exp_avg_sqs))
    device = quads[0][0].device
    if device.type != "cuda":
        raise ValueError(f"adam: tensors on {device}, not a CUDA device")
    index = device.index
    for k, quad in enumerate(quads):
        n = quad[0].numel()
        for name, t in zip(("param", "grad", "exp_avg", "exp_avg_sq"), quad):
            if (t.dtype is not torch.float32 or not t.is_cuda or t.get_device() != index
                    or not t.is_contiguous() or t.numel() != n):
                raise ValueError(
                    f"adam: {name} {k} is {t.dtype} {tuple(t.shape)} on {t.device}"
                    f"{'' if t.is_contiguous() else ', not contiguous'}; needs contiguous "
                    f"float32 of its param's {n} elements on {device}")
    ptrs = np.array([[t.data_ptr() for t in quad] for quad in quads], dtype=np.uint64)
    return device, ptrs, np.array([p.numel() for p in params], dtype=np.int64)


def _launch(device: torch.device, ptrs: np.ndarray, numels: np.ndarray, steps: Sequence[float],
            lr: float, beta1: float, beta2: float, eps: float, weight_decay: float) -> None:
    """Launch the pass over a checked table: ``ptrs`` (count, 4) uint64 of
    (param, grad, exp_avg, exp_avg_sq) addresses, ``numels`` (count,)
    int64, one launch for each ``MAX_TENSORS`` rows that hold an element."""
    per_step = {step: corrections(step, lr, beta1, beta2) for step in set(steps)}
    factors = np.array([per_step[step] for step in steps], dtype=np.float32)
    neg_steps, bc2_sqrts = np.ascontiguousarray(factors[:, 0]), np.ascontiguousarray(factors[:, 1])
    fn = _build.library("adam").fenet_adam
    scalars = [ctypes.c_float(x) for x in (1 - beta1, beta2, 1 - beta2, eps, weight_decay)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for start in range(0, len(numels), MAX_TENSORS):
            count = min(MAX_TENSORS, len(numels) - start)
            status = fn(ptrs[start:].ctypes.data, numels[start:].ctypes.data,
                        neg_steps[start:].ctypes.data, bc2_sqrts[start:].ctypes.data, count,
                        *scalars, stream)
            _build.check(status, "adam")
            adam_kernel.launches += bool(numels[start:start + count].any())
    adam_kernel.elements += int(numels.sum())


def adam_kernel(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                exp_avgs: Sequence[torch.Tensor], exp_avg_sqs: Sequence[torch.Tensor],
                steps: Sequence[float], *, lr: float, beta1: float, beta2: float, eps: float,
                weight_decay: float) -> None:
    """Launch ``csrc/adam.cu`` on the current stream (replaces no Pallas
    kernel: fenet's Adam is optax under XLA).

    The tensors: float32, contiguous, on one CUDA device, each (param, grad,
    exp_avg, exp_avg_sq) of one size; ``steps`` each tensor's step count
    after this step. Updates params and both moments in place; reads the
    gradients only. No host sync, nothing allocated on the device. Adds its
    launches to ``adam_kernel.launches`` and the elements it updated to
    ``adam_kernel.elements`` (which :class:`Adam` sets to 0 before a step).
    """
    if params:
        _launch(*_table(params, grads, exp_avgs, exp_avg_sqs), steps, lr, beta1, beta2, eps,
                weight_decay)


adam_kernel.launches = 0
adam_kernel.elements = 0


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` (same arguments, state and ``state_dict``)
    whose step on CUDA parameters is :func:`adam_kernel`'s pass: one launch
    over every parameter with a gradient, per group. CPU parameters take
    torch's own step; a group on the card that asks for an option the pass
    does not compute (amsgrad, maximize, capturable, differentiable, fused,
    decoupled decay, a tensor lr) raises, as does a step over CPU and CUDA
    parameters at once. Each step checks its tensors and builds the launch
    table anew: the gradients, and any param or moment replaced since,
    have new addresses."""

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        groups = [[p for p in group["params"] if p.grad is not None]
                  for group in self.param_groups]
        on_card = {p.is_cuda for params in groups for p in params}
        if True not in on_card:
            super().step()
            return loss
        if False in on_card:
            raise ValueError("Adam: one step over CPU and CUDA parameters; the CUDA pass "
                             "takes parameters on the card only")
        adam_kernel.elements = 0
        for group, params in zip(self.param_groups, groups):
            if params:
                self._step_group(group, params)
        return loss

    def _step_group(self, group: Dict, params: List[torch.Tensor]) -> None:
        on = [key for key in _UNSUPPORTED if group.get(key)]
        if on or isinstance(group["lr"], torch.Tensor):
            raise ValueError(f"Adam: the CUDA pass computes plain Adam with a float lr; the "
                             f"group asks for {on or ['a tensor lr']}")
        states = [self._state(p) for p in params]
        table = _table(params, [p.grad for p in params], [s["exp_avg"] for s in states],
                       [s["exp_avg_sq"] for s in states])
        steps = [s["step"] for s in states]
        # torch's increment of its CPU step counts (the overload that does
        # not wrap the scalar for each tensor), once the table is checked
        torch._foreach_add_(steps, torch.tensor(1.0), alpha=1.0)
        beta1, beta2 = group["betas"]
        _launch(*table, [s.item() for s in steps], group["lr"], beta1, beta2, group["eps"],
                group["weight_decay"])

    def _state(self, p: torch.Tensor) -> Dict:
        """p's state, made as torch's Adam makes it on a first step: a CPU
        step count and two zero moments shaped as p."""
        state = self.state[p]
        if not state:
            state["step"] = torch.tensor(0.0, dtype=(torch.float64 if torch.get_default_dtype()
                                                     == torch.float64 else torch.float32))
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state
