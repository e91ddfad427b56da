"""A test fixture, copied into a copy of the benchmark as a configuration's
own reference: the generator of ``reference/generator.py`` on a RepVGG
backbone whose every block ends in a squeeze-and-excite gate before its
ReLU, the block of RepVGG-D2se (Ding et al., RepVGG, CVPR 2021,
``repvgg.py`` ``SEBlock``): the summed branches x of a block of C channels
are scaled channel by channel by sigmoid(up(relu(down(mean over h, w of
x)))), ``down`` a biased linear C -> C // 16 and ``up`` one C // 16 -> C.
The gate stays as it is in the deploy form. The edge branch, the decoder,
the branches and their fold are ``generator.py``'s.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench import inputs
from portbench.reference import generator as plain
from portbench.reference.precision import FLOAT32, Operands

GATE_STREAM = 1  # the gates' draw: a stream of its own of the weights' seed


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
    w = torch.relu(net.linear(x.mean(dim=(2, 3)), f"{name}.se.down"))
    return x * torch.sigmoid(net.linear(w, f"{name}.se.up"))[:, :, None, None]


def _edge(net, x, p):
    e = net.conv(x, plain.edge_kernel(x.device), 1, 1)
    e = torch.relu(net.bn(net.conv(e, p["edge0.0.weight"], 2, 1), "edge0.1."))
    e = torch.relu(net.bn(net.conv(e, p["edge2.0.weight"], 2, 1), "edge2.1."))
    return net.linear(e.flatten(1), "linear")


def forward(p: Dict[str, torch.Tensor], images: torch.Tensor, cfg, train: bool,
            ops: Operands = FLOAT32):
    """(pc1, pc2, pc3) of the branched generator, each block gated."""
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
