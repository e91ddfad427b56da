"""Floating-point operations of the generator a sample, counted as
``torch.utils.flop_counter`` counts them: 2 a multiply-add of every
convolution and matrix product, nothing for BatchNorm, activations or
additions. A backward computes the gradient of each product's input where
that input needs one (not of the images, nor of the fixed edge filter's
output) and of its weight where the weight is trained (not the edge
filter)."""

from __future__ import annotations

from portbench.reference.generator import _decoder_layers, blocks


def _layers(cfg, deploy: bool):
    """(flops a sample, input needs a gradient, weight trained) of every
    product of the generator's forward."""
    hw = cfg["image_hw"]
    out = [(2 * 3 * 3 * 9 * hw * hw, False, False)]  # the fixed edge filter, stride 1
    c1, c2 = cfg["edge_channels"]
    out.append((2 * 3 * c1 * 9 * (hw // 2) ** 2, False, True))
    out.append((2 * c1 * c2 * 9 * (hw // 4) ** 2, True, True))
    out.append((2 * c2 * (hw // 4) ** 2 * 1000, True, True))
    side, first = hw, True
    for _, cin, cout, stride in blocks(cfg):
        side //= stride
        area = side * side
        out.append((2 * cin * cout * 9 * area, not first, True))
        if not deploy:  # the 1x1 branch
            out.append((2 * cin * cout * area, not first, True))
        first = False
    out.append((2 * blocks(cfg)[-1][2] * cfg["num_classes"], True, True))
    for name, fin, fout in _decoder_layers(cfg):
        # the 1x1 convs run over 256 points (fine head) or 128 (mid head)
        length = 1 if name.startswith("fc") else (128 if name == "conv2_1" else 256)
        out.append((2 * fin * fout * length, True, True))
    return out


def forward_flops(cfg) -> int:
    """The branched generator's forward, a sample."""
    return sum(f for f, _, _ in _layers(cfg, deploy=False))


def train_flops(cfg) -> int:
    """Forward and backward of the branched generator, a sample."""
    return sum(f * (1 + int(needs_input) + int(trained))
               for f, needs_input, trained in _layers(cfg, deploy=False))


def deploy_flops(cfg) -> int:
    """The folded generator's forward, a sample: one 3x3 conv a block."""
    return sum(f for f, _, _ in _layers(cfg, deploy=True))
