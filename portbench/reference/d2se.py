"""The plain reference of configuration ``d2se_1024``: the cmlp generator of
``generator.py`` on RepVGG-D2se (Ding et al., *RepVGG: Making VGG-style
ConvNets Great Again*, CVPR 2021; github.com/DingXiaoH/RepVGG ``repvgg.py``
``create_RepVGG_D2se``), in plain PyTorch and float32.

RepVGG-D2se is RepVGG's backbone at blocks [8, 14, 24, 1] (48 with stage
0) and width multipliers [2.5, 2.5, 2.5, 5], every block of it gated by
squeeze and excite (``use_se=True``, ``SEBlock``). In a block of C output
channels whose branches sum to x (B, C, h, w):

    s = mean over h, w of x                     (B, C)
    z = relu(W_down s + b_down)                 W_down (C/16, C), b_down (C/16)
    g = sigmoid(W_up z + b_up)                  W_up (C, C/16), b_up (C)
    y = relu(x * g[:, :, None, None])

The deploy form keeps the gate as it is, on the folded conv's output. The
edge branch, the decoder, the branches and their fold are ``generator.py``'s.

Departures from the published code, each exact here:

- The published gate's ``down`` and ``up`` are biased 1x1 ``Conv2d``s on
  ``F.avg_pool2d(x, kernel_size=x.size(3))``; here they are linears on
  ``x.mean((2, 3))``: the same arithmetic wherever the map is square, as
  every map of this generator is (128x128 images, stride 2 at each stage's
  first block).
- Hence the gate's weights are (C/16, C) and (C, C/16), where the
  published state holds them as (C/16, C, 1, 1) and (C, C/16, 1, 1). The
  names (``RepVGG.stage1.0.se.down.weight``, ...) are the published ones.

Every forward here runs with the card's TF32 switches off
(``exact_float32``); a backward through it is taken inside the traffic
kind's own ``exact_float32``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench import inputs
from portbench.reference import generator as plain
from portbench.reference.precision import FLOAT32, Operands, exact_float32

# The gates' draw: a stream of the weights' seed of its own, after the
# numbers that ``inputs`` gives its streams (0-4).
GATE_STREAM = 5


def gates(cfg):
    """(block name, channels, inner channels) of every gate."""
    return [(name, cout, cout // 16) for name, _, cout, _ in plain.blocks(cfg)]


def _gate_spec(cfg):
    out = []
    for name, c, inner in gates(cfg):
        out += [(f"{name}.se.down.weight", (inner, c), "weight", c),
                (f"{name}.se.down.bias", (inner,), "bias", c),
                (f"{name}.se.up.weight", (c, inner), "weight", inner),
                (f"{name}.se.up.bias", (c,), "bias", inner)]
    return out


def spec(cfg):
    """The generator's entries, then every gate's."""
    return plain.spec(cfg) + _gate_spec(cfg)


def parameter_count(cfg) -> int:
    return plain.parameter_count(cfg) + sum(math.prod(shape) for _, shape, _, _ in _gate_spec(cfg))


@torch.no_grad()
def init(cfg, seed: int, device, head_scale: float = 1.0,
         random_bn: bool = False) -> Dict[str, torch.Tensor]:
    """The generator's state from ``seed``, and every gate's weight and
    bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from one draw of a stream of
    its own."""
    state = plain.init(cfg, seed, device, head_scale, random_bn)
    entries = _gate_spec(cfg)
    gen = torch.Generator(device=device).manual_seed(inputs.stream_seed(seed, GATE_STREAM))
    draw = torch.rand(sum(math.prod(e[1]) for e in entries), generator=gen, device=device)
    at = 0
    for name, shape, _, fan_in in entries:
        size, bound = math.prod(shape), 1.0 / math.sqrt(fan_in)
        state[name] = (draw[at:at + size] * (2.0 * bound) - bound).reshape(shape).contiguous()
        at += size
    return state


def _gate(net, x, name):
    z = torch.relu(net.linear(x.mean(dim=(2, 3)), f"{name}.se.down"))
    return x * torch.sigmoid(net.linear(z, f"{name}.se.up"))[:, :, None, None]


def _edge(net, x, p):
    e = net.conv(x, plain.edge_kernel(x.device), 1, 1)
    e = torch.relu(net.bn(net.conv(e, p["edge0.0.weight"], 2, 1), "edge0.1."))
    e = torch.relu(net.bn(net.conv(e, p["edge2.0.weight"], 2, 1), "edge2.1."))
    return net.linear(e.flatten(1), "linear")


def forward(p: Dict[str, torch.Tensor], images: torch.Tensor, cfg, train: bool,
            ops: Operands = FLOAT32):
    """(pc1, pc2, pc3) of the branched generator, each block gated."""
    with exact_float32():
        net = plain._Net(p, train, ops)
        x = h = plain.images_nchw(images)
        for name, cin, cout, stride in plain.blocks(cfg):
            out = (net.bn(net.conv(h, p[f"{name}.rbr_dense.conv.weight"], stride, 1),
                          f"{name}.rbr_dense.bn.")
                   + net.bn(net.conv(h, p[f"{name}.rbr_1x1.conv.weight"], stride, 0),
                            f"{name}.rbr_1x1.bn."))
            if cin == cout and stride == 1:
                out = out + net.bn(h, f"{name}.rbr_identity.")
            h = torch.relu(_gate(net, out, name))
        head = net.linear(h.mean(dim=(2, 3)), "RepVGG.linear")
        return plain._decode(net, cfg, torch.cat([head, _edge(net, x, p)], dim=1))


@torch.no_grad()
def fold(p: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """The generator's fold, with every gate as it is."""
    return {**plain.fold(p, cfg), **{k: v for k, v in p.items() if ".se." in k}}


@torch.no_grad()
def deploy_forward(q: Dict[str, torch.Tensor], images: torch.Tensor, cfg,
                   ops: Operands = FLOAT32) -> torch.Tensor:
    """The final cloud of the folded generator, each block gated."""
    with exact_float32():
        net = plain._Net(q, False, ops)
        x = h = plain.images_nchw(images)
        for name, _, _, stride in plain.blocks(cfg):
            h = torch.relu(_gate(net, net.conv(h, q[f"{name}.kernel"], stride, 1,
                                               q[f"{name}.bias"]), name))
        head = net.linear(h.mean(dim=(2, 3)), "RepVGG.linear")
        e = net.conv(x, plain.edge_kernel(x.device), 1, 1)
        for name in ("edge0", "edge2"):
            e = torch.relu(net.conv(e, q[f"{name}.kernel"], 2, 1, q[f"{name}.bias"]))
        return plain._decode(net, cfg, torch.cat([head, net.linear(e.flatten(1), "linear")],
                                                 dim=1))[2]
