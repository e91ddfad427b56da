"""Floating-point operations of configuration ``d2se_1024``, a sample:
``generator.py``'s FLOPs and each block's squeeze-and-excite gate, two
biased linears C -> C // 16 -> C, counted as ``torch.utils.flop_counter``
counts them (2 a multiply-add; nothing for the mean, the activations or
the channel scale). A gate's input needs a gradient (it follows trained
convolutions) and its weights are trained, in every block; the deploy form
keeps every gate."""

from __future__ import annotations

from portbench.counts import generator as plain
from portbench.reference.generator import blocks


def _gate_flops(cfg) -> int:
    return sum(2 * 2 * cout * (cout // 16) for _, _, cout, _ in blocks(cfg))


def forward_flops(cfg) -> int:
    return plain.forward_flops(cfg) + _gate_flops(cfg)


def train_flops(cfg) -> int:
    return plain.train_flops(cfg) + 3 * _gate_flops(cfg)


def deploy_flops(cfg) -> int:
    return plain.deploy_flops(cfg) + _gate_flops(cfg)
