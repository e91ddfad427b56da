"""Adam with L2 decay added to the gradient before the moments (not AdamW),
bias-corrected, as the reference's ``torch.optim.Adam(weight_decay=...)``."""

from __future__ import annotations

import math
from typing import Dict

import torch


class Adam:
    def __init__(self, lr: float, weight_decay: float, betas=(0.9, 0.999), eps: float = 1e-8):
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, betas, eps
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        """Update ``params`` in place from ``grads`` (same keys)."""
        b1, b2 = self.betas
        self.t += 1
        bc1, bc2 = 1.0 - b1 ** self.t, 1.0 - b2 ** self.t
        for name, p in params.items():
            g = grads[name] + self.wd * p
            m = self.m[name] = b1 * self.m.get(name, torch.zeros_like(p)) + (1.0 - b1) * g
            v = self.v[name] = b2 * self.v.get(name, torch.zeros_like(p)) + (1.0 - b2) * g * g
            p -= (self.lr / bc1) * m / (torch.sqrt(v) / math.sqrt(bc2) + self.eps)
