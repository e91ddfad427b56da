"""The reference repository's image -> point-cloud generator in plain
PyTorch (``models/repvgg_edge_nose_NEW_cmlp.py``): a RepVGG backbone and
its 1000-way head, the fixed-filter edge branch, and the cascaded decoder
(128 -> 256 -> num_points points).

Weights live in one flat dict under the reference's state_dict names, so
the same dict loads into the program with ``strict=True``. :func:`spec`
lists every entry with its shape, :func:`init` fills them on the device
from a seed in two draws, :func:`forward` runs the branched generator in
train-mode or eval-mode BatchNorm, and :func:`fold` with
:func:`deploy_forward` is the serving form: one biased 3x3 conv a block.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import FLOAT32, Operands

BN_EPS = 1e-5
BN_LEAVES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")
HEADS = ("fc3_1", "conv2_1", "conv1_3")  # the decoder's three output layers
_EDGE = [[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]]


def blocks(cfg) -> List[Tuple[str, int, int, int]]:
    """(name, in channels, out channels, stride) of every RepVGG block."""
    wm, counts = cfg["width_multiplier"], cfg["num_blocks"]
    c0 = min(64, int(64 * wm[0]))
    out = [("RepVGG.stage0", 3, c0, 2)]
    cin = c0
    widths = [int(64 * wm[0]), int(128 * wm[1]), int(256 * wm[2]), int(512 * wm[3])]
    for s, (width, count) in enumerate(zip(widths, counts), start=1):
        for j in range(count):
            out.append((f"RepVGG.stage{s}.{j}", cin, width, 2 if j == 0 else 1))
            cin = width
    return out


def _decoder_layers(cfg) -> List[Tuple[str, int, int]]:
    """(name, in, out) of the decoder's linears and 1x1 convs."""
    fine, mid, k = cfg["fine_width"], cfg["mid_width"], cfg["num_points"] // 256
    return [("fc1", 2000, 1024), ("fc2", 1024, 512), ("fc3", 512, 256),
            ("fc1_1", 1024, 256 * fine), ("fc2_1", 512, 128 * mid), ("fc3_1", 256, 384),
            ("conv1_1", fine, fine), ("conv1_2", fine, 256), ("conv1_3", 256, 3 * k),
            ("conv2_1", mid, 6)]


def spec(cfg) -> List[Tuple[str, Tuple[int, ...], str, int]]:
    """Every state_dict entry in order: (name, shape, kind, fan_in). Kinds:
    ``weight`` and ``bias`` (drawn U(-1/sqrt(fan_in), 1/sqrt(fan_in))), and
    the BatchNorm leaves ``bn_weight``, ``bn_bias``, ``bn_mean``, ``bn_var``,
    ``bn_count``."""
    out = []

    def bn(prefix, c):
        for leaf, kind in zip(BN_LEAVES, ("bn_weight", "bn_bias", "bn_mean", "bn_var",
                                          "bn_count")):
            out.append((prefix + leaf, () if kind == "bn_count" else (c,), kind, 0))

    for name, cin, cout, stride in blocks(cfg):
        out.append((f"{name}.rbr_dense.conv.weight", (cout, cin, 3, 3), "weight", cin * 9))
        bn(f"{name}.rbr_dense.bn.", cout)
        out.append((f"{name}.rbr_1x1.conv.weight", (cout, cin, 1, 1), "weight", cin))
        bn(f"{name}.rbr_1x1.bn.", cout)
        if cin == cout and stride == 1:
            bn(f"{name}.rbr_identity.", cin)
    feat = blocks(cfg)[-1][2]
    classes = cfg["num_classes"]
    out += [("RepVGG.linear.weight", (classes, feat), "weight", feat),
            ("RepVGG.linear.bias", (classes,), "bias", feat)]
    c1, c2 = cfg["edge_channels"]
    out.append(("edge0.0.weight", (c1, 3, 3, 3), "weight", 27))
    bn("edge0.1.", c1)
    out.append(("edge2.0.weight", (c2, c1, 3, 3), "weight", c1 * 9))
    bn("edge2.1.", c2)
    flat = c2 * (cfg["image_hw"] // 4) ** 2
    out += [("linear.weight", (1000, flat), "weight", flat),
            ("linear.bias", (1000,), "bias", flat)]
    for name, fin, fout in _decoder_layers(cfg):
        shape = (fout, fin) if name.startswith("fc") else (fout, fin, 1)
        out += [(f"{name}.weight", shape, "weight", fin), (f"{name}.bias", (fout,), "bias", fin)]
    return out


def parameter_count(cfg) -> int:
    """Trainable parameters: every weight and bias and the BN affine pairs."""
    return sum(math.prod(shape) for _, shape, kind, _ in spec(cfg)
               if kind in ("weight", "bias", "bn_weight", "bn_bias"))


@torch.no_grad()
def init(cfg, seed: int, device, head_scale: float = 1.0,
         random_bn: bool = False) -> Dict[str, torch.Tensor]:
    """The flat state on ``device`` from ``seed``: every weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) from one uniform draw; BatchNorm the
    identity (weight 1, bias 0, mean 0, var 1), or with ``random_bn`` its
    affine pair and statistics from a second draw (weight U(0.5, 1.5), bias
    U(-0.3, 0.3), mean U(-0.5, 0.5), var U(0.5, 2)). The decoder's three
    output layers are scaled by ``head_scale``."""
    entries = spec(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dense = [e for e in entries if e[2] in ("weight", "bias")]
    draw = torch.rand(sum(math.prod(e[1]) for e in dense), generator=gen, device=device)
    bn_draw = (torch.rand(sum(math.prod(e[1]) for e in entries if e[2].startswith("bn_")
                              and e[2] != "bn_count"), generator=gen, device=device)
               if random_bn else None)
    ranges = {"bn_weight": (0.5, 1.5), "bn_bias": (-0.3, 0.3), "bn_mean": (-0.5, 0.5),
              "bn_var": (0.5, 2.0)}
    identity = {"bn_weight": 1.0, "bn_bias": 0.0, "bn_mean": 0.0, "bn_var": 1.0}
    state, at, bn_at = {}, 0, 0
    for name, shape, kind, fan_in in entries:
        size = math.prod(shape)
        if kind in ("weight", "bias"):
            bound = 1.0 / math.sqrt(fan_in)
            leaf = (draw[at:at + size] * (2.0 * bound) - bound).reshape(shape)
            at += size
            if name.split(".")[0] in HEADS:
                leaf = leaf * head_scale
        elif kind == "bn_count":
            leaf = torch.zeros((), dtype=torch.int64, device=device)
        elif bn_draw is not None:
            lo, hi = ranges[kind]
            leaf = bn_draw[bn_at:bn_at + size] * (hi - lo) + lo
            bn_at += size
        else:
            leaf = torch.full(shape, identity[kind], device=device)
        state[name] = leaf.contiguous()
    return state


def edge_kernel(device) -> torch.Tensor:
    """The fixed 3x3 edge filter, divided by 3, for every (out, in) pair."""
    k = torch.tensor(_EDGE, dtype=torch.float32, device=device) / 3.0
    return k.expand(3, 3, 3, 3).contiguous()


def images_nchw(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) pixels 0..255 -> float32 NCHW."""
    return images.to(torch.float32).permute(0, 3, 1, 2).contiguous()


class _Net:
    """The functional layers over one state dict."""

    def __init__(self, p: Dict[str, torch.Tensor], train: bool, ops: Operands):
        self.p, self.train, self.ops = p, train, ops

    def conv(self, x, w, stride=1, padding=0, bias=None):
        return F.conv2d(self.ops(x), self.ops(w), bias, stride, padding)

    def bn(self, x, prefix):
        p = self.p
        if self.train:  # the batch's statistics; no running statistics kept
            return F.batch_norm(x, None, None, p[prefix + "weight"], p[prefix + "bias"],
                                True, 0.0, BN_EPS)
        return F.batch_norm(x, p[prefix + "running_mean"], p[prefix + "running_var"],
                            p[prefix + "weight"], p[prefix + "bias"], False, 0.0, BN_EPS)

    def linear(self, x, name):
        return F.linear(self.ops(x), self.ops(self.p[name + ".weight"]), self.p[name + ".bias"])

    def conv1d(self, x, name):
        return F.conv1d(self.ops(x), self.ops(self.p[name + ".weight"]), self.p[name + ".bias"])


def _backbone(net: _Net, cfg, x: torch.Tensor) -> torch.Tensor:
    p = net.p
    for name, cin, cout, stride in blocks(cfg):
        out = (net.bn(net.conv(x, p[f"{name}.rbr_dense.conv.weight"], stride, 1),
                      f"{name}.rbr_dense.bn.")
               + net.bn(net.conv(x, p[f"{name}.rbr_1x1.conv.weight"], stride, 0),
                        f"{name}.rbr_1x1.bn."))
        if cin == cout and stride == 1:
            out = out + net.bn(x, f"{name}.rbr_identity.")
        x = torch.relu(out)
    return x


def _decode(net: _Net, cfg, feat: torch.Tensor):
    b, n = feat.shape[0], cfg["num_points"]
    x1 = torch.relu(net.linear(feat, "fc1"))
    x2 = torch.relu(net.linear(x1, "fc2"))
    x3 = torch.relu(net.linear(x2, "fc3"))
    pc1 = net.linear(x3, "fc3_1").reshape(b, 128, 3)
    mid = torch.relu(net.linear(x2, "fc2_1")).reshape(b, -1, 128)
    off2 = net.conv1d(mid, "conv2_1").transpose(1, 2).reshape(b, 128, 2, 3)
    pc2 = (pc1[:, :, None, :] + off2).reshape(b, 256, 3)
    fine = torch.relu(net.linear(x1, "fc1_1")).reshape(b, -1, 256)
    fine = torch.relu(net.conv1d(fine, "conv1_1"))
    fine = torch.relu(net.conv1d(fine, "conv1_2"))
    off3 = net.conv1d(fine, "conv1_3").transpose(1, 2).reshape(b, 256, n // 256, 3)
    pc3 = (pc2[:, :, None, :] + off3).reshape(b, n, 3)
    return pc1, pc2, pc3


def forward(p: Dict[str, torch.Tensor], images: torch.Tensor, cfg, train: bool,
            ops: Operands = FLOAT32):
    """(pc1, pc2, pc3) of the branched generator for (B, H, W, 3) images:
    BatchNorm on the batch's statistics with ``train``, on the running ones
    without."""
    net = _Net(p, train, ops)
    x = images_nchw(images)
    feat = _backbone(net, cfg, x)
    head = net.linear(feat.mean(dim=(2, 3)), "RepVGG.linear")
    e = net.conv(x, edge_kernel(x.device), 1, 1)
    e = torch.relu(net.bn(net.conv(e, p["edge0.0.weight"], 2, 1), "edge0.1."))
    e = torch.relu(net.bn(net.conv(e, p["edge2.0.weight"], 2, 1), "edge2.1."))
    edge = net.linear(e.flatten(1), "linear")
    return _decode(net, cfg, torch.cat([head, edge], dim=1))


def _fuse(w, p, prefix):
    t = p[prefix + "weight"] / torch.sqrt(p[prefix + "running_var"] + BN_EPS)
    return w * t.reshape(-1, *([1] * (w.dim() - 1))), p[prefix + "bias"] - p[prefix + "running_mean"] * t


@torch.no_grad()
def fold(p: Dict[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """The deploy form: each block's three branches and their BatchNorms as
    one biased 3x3 conv (``{block}.kernel``, ``{block}.bias``), each edge
    conv with its BatchNorm folded in; every other entry as it is."""
    out = {k: v for k, v in p.items() if not k.startswith(("RepVGG.stage", "edge0", "edge2"))}
    for name, cin, cout, stride in blocks(cfg):
        k3, b3 = _fuse(p[f"{name}.rbr_dense.conv.weight"], p, f"{name}.rbr_dense.bn.")
        k1, b1 = _fuse(p[f"{name}.rbr_1x1.conv.weight"], p, f"{name}.rbr_1x1.bn.")
        kernel, bias = k3 + F.pad(k1, (1, 1, 1, 1)), b3 + b1
        if cin == cout and stride == 1:
            ident = torch.zeros_like(k3)
            ident[torch.arange(cout), torch.arange(cout), 1, 1] = 1.0
            kid, bid = _fuse(ident, p, f"{name}.rbr_identity.")
            kernel, bias = kernel + kid, bias + bid
        out[f"{name}.kernel"], out[f"{name}.bias"] = kernel, bias
    for name in ("edge0", "edge2"):
        out[f"{name}.kernel"], out[f"{name}.bias"] = _fuse(p[f"{name}.0.weight"], p, f"{name}.1.")
    return out


@torch.no_grad()
def deploy_forward(q: Dict[str, torch.Tensor], images: torch.Tensor, cfg,
                   ops: Operands = FLOAT32) -> torch.Tensor:
    """The final cloud (B, num_points, 3) of the folded generator."""
    net = _Net(q, False, ops)
    x = images_nchw(images)
    h = x
    for name, _, _, stride in blocks(cfg):
        h = torch.relu(net.conv(h, q[f"{name}.kernel"], stride, 1, q[f"{name}.bias"]))
    head = net.linear(h.mean(dim=(2, 3)), "RepVGG.linear")
    e = net.conv(x, edge_kernel(x.device), 1, 1)
    for name in ("edge0", "edge2"):
        e = torch.relu(net.conv(e, q[f"{name}.kernel"], 2, 1, q[f"{name}.bias"]))
    edge = net.linear(e.flatten(1), "linear")
    return _decode(net, cfg, torch.cat([head, edge], dim=1))[2]
