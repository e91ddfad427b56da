"""Image -> point-cloud generator: RepVGG backbone + edge branch + cascaded
decoder (counterpart of ``fenet/models/generator.py``). ``model.eval()``
matches ``Generator.apply(train=False)``; ``model.train()`` matches
``Generator.apply(train=True, mutable=["batch_stats"])``, running statistics
included.

Inputs keep the JAX package's layout, (B, 128, 128, 3) uint8 or float with
raw 0..255 values; the generator permutes to NCHW once. Clouds come out
(B, N, 3). The state_dict uses the reference's flat names (``RepVGG.*``,
``edge0.*``, ``edge2.*``, ``linear``, ``fc1`` ... ``conv2_1``), so a reference
``.pth.tar`` loads with ``strict=True``; the decoder's per-point layers are
``Conv1d(k=1)`` over torch's native (B, C, L).

``Generator(deploy=True)`` is the serving form: every RepVGG block one
biased 3x3 conv, the edge convs biased with no BN. :func:`to_deploy` folds
a branched model into it, in float32 and optionally cast to bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fenet_torch.models.repvgg import (
    REPVGG_CONFIGS,
    BatchNorm2d,
    RepVGG,
    _bn,
    _fuse_conv_bn,
    fold_repvgg_params,
)
from fenet_torch.parallel.mesh import copy_to_group, reduce_from_group

# The reference's fixed 3x3 edge filter, the same for every (out, in) pair.
_EDGE_KERNEL = np.array(
    [[-1.0, -1.0, -1.0], [-1.0, 8.0, -1.0], [-1.0, -1.0, -1.0]], np.float32
) / 3.0


def edge_kernel() -> torch.Tensor:
    """The (3, 3, 3, 3) broadcast of ``_EDGE_KERNEL`` as float32, made on the
    default device, so a model built under ``torch.device(...)`` holds it
    there with its parameters."""
    return torch.tensor(np.broadcast_to(_EDGE_KERNEL, (3, 3, 3, 3)))


def edge_conv2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Fixed edge-detection conv on NCHW (B, 3, H, W); ``kernel`` is the
    :func:`edge_kernel`."""
    return F.conv2d(x, kernel, padding=1)


def _edge_conv(cin: int, cout: int, deploy: bool) -> nn.Sequential:
    if deploy:  # BN folded into the conv's bias
        return nn.Sequential(nn.Conv2d(cin, cout, 3, 2, 1, bias=True), nn.ReLU())
    return nn.Sequential(
        nn.Conv2d(cin, cout, 3, 2, 1, bias=False),
        BatchNorm2d(cout),
        nn.ReLU(),
    )


class EdgeBranch(nn.Module):
    """Fixed edge conv -> two strided conv+BN+ReLU (deploy: biased conv +
    ReLU) -> 1000-d linear."""

    def __init__(self, deploy: bool = False):
        super().__init__()
        self.edge0 = _edge_conv(3, 16, deploy)  # (B, 16, 64, 64)
        self.edge2 = _edge_conv(16, 3, deploy)  # (B, 3, 32, 32)
        self.linear = nn.Linear(3 * 32 * 32, 1000)

    def forward(self, x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
        e = self.edge2(self.edge0(edge_conv2d(x, kernel)))
        return self.linear(e.flatten(1))  # (C, H, W) order, as the reference


class CascadedDecoder(nn.Module):
    """Coarse-to-fine decoder: 128 points, 2x offsets -> 256, then
    (num_points/256)x offsets -> num_points.

    Under tensor parallelism (``tp_group`` set by
    :func:`fenet_torch.parallel.tp.shard_model_`) each rank holds a
    contiguous block of ``fc1_1``'s and ``fc2_1``'s output rows
    (column-parallel: whole channels of the channel-major reshape) and the
    matching input channels of ``conv1_1`` and ``conv2_1`` (row-parallel);
    the row-parallel outputs are summed over the group and their bias is
    added once, after the sum.
    """

    def __init__(self, num_points: int = 1024, fine_width: int = 512,
                 mid_width: int = 128):
        super().__init__()
        if num_points % 256 != 0:
            raise ValueError("num_points must be a multiple of 256")
        self.num_points, self.fine_width, self.mid_width = num_points, fine_width, mid_width
        self.fc1 = nn.Linear(2000, 1024)
        self.fc2 = nn.Linear(1024, 512)
        self.fc3 = nn.Linear(512, 256)
        self.fc1_1 = nn.Linear(1024, 256 * fine_width)
        self.fc2_1 = nn.Linear(512, 128 * mid_width)
        self.fc3_1 = nn.Linear(256, 128 * 3)
        self.conv1_1 = nn.Conv1d(fine_width, fine_width, 1)
        self.conv1_2 = nn.Conv1d(fine_width, 256, 1)
        self.conv1_3 = nn.Conv1d(256, 3 * (num_points // 256), 1)
        self.conv2_1 = nn.Conv1d(mid_width, 6, 1)
        self.tp_group = None

    def _column(self, fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is not None:
            x = copy_to_group(x, self.tp_group)
        return fc(x)

    def _row(self, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        if self.tp_group is None:
            return conv(x)
        return reduce_from_group(F.conv1d(x, conv.weight), self.tp_group) + conv.bias[:, None]

    def forward(self, feat: torch.Tensor):
        b = feat.shape[0]
        x1 = torch.relu(self.fc1(feat))
        x2 = torch.relu(self.fc2(x1))
        x3 = torch.relu(self.fc3(x2))
        pc1 = self.fc3_1(x3).reshape(b, 128, 3)

        pc2_feat = torch.relu(self._column(self.fc2_1, x2)).reshape(b, -1, 128)
        pc2_off = self._row(self.conv2_1, pc2_feat).transpose(1, 2).reshape(b, 128, 2, 3)
        pc2 = (pc1[:, :, None, :] + pc2_off).reshape(b, 256, 3)

        k = self.num_points // 256
        pc3_feat = torch.relu(self._column(self.fc1_1, x1)).reshape(b, -1, 256)
        pc3_feat = torch.relu(self._row(self.conv1_1, pc3_feat))
        pc3_feat = torch.relu(self.conv1_2(pc3_feat))
        pc3_off = self.conv1_3(pc3_feat).transpose(1, 2).reshape(b, 256, k, 3)
        pc3 = (pc2[:, :, None, :] + pc3_off).reshape(b, self.num_points, 3)
        return pc1, pc2, pc3


class Generator(nn.Module):
    """The cmlp cascaded generator. ``forward(images) -> (pc1, pc2, pc3)``,
    (B,128,3), (B,256,3), (B,num_points,3), in the parameters' dtype."""

    def __init__(self, num_points: int = 1024, backbone: str = "RepVGG-A2",
                 fine_width: int = 512, mid_width: int = 128, deploy: bool = False):
        super().__init__()
        self.num_points, self.backbone = num_points, backbone
        self.fine_width, self.mid_width, self.deploy = fine_width, mid_width, deploy
        self.RepVGG = RepVGG(REPVGG_CONFIGS[backbone], deploy)
        # The parts' layers are registered on the generator itself, so the
        # state_dict keeps the reference's flat names; the parts are held
        # outside the module tree only for their forward.
        self._parts = (EdgeBranch(deploy), CascadedDecoder(num_points, fine_width, mid_width))
        for part in self._parts:
            for name, child in part.named_children():
                self.add_module(name, child)
        self.register_buffer("edge_kernel", edge_kernel(), persistent=False)

    @property
    def decoder(self) -> CascadedDecoder:
        return self._parts[1]

    def forward(self, images: torch.Tensor):
        x = _nchw(images, self.fc1.weight.dtype)
        return self._decode(self.RepVGG.forward_features(x), x)

    def decode(self, feature_map: torch.Tensor, images: torch.Tensor):
        """The path from a backbone feature map (B, C, h, w) on, with the
        (B, H, W, 3) images for the edge branch: Grad-CAM's re-entry point.
        ``decode(RepVGG.forward_features(x), images)`` is ``forward``."""
        return self._decode(feature_map, _nchw(images, self.fc1.weight.dtype))

    def _decode(self, feature_map: torch.Tensor, x: torch.Tensor):
        edge_branch, decoder = self._parts
        feat = self.RepVGG.head(feature_map)
        edge = edge_branch(x, self.edge_kernel)
        return decoder(torch.cat([feat, edge], dim=1))


def _nchw(images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) images -> NCHW in the parameters' dtype, so that a bf16
    fold computes in bf16 (the edge kernel buffer is cast with them)."""
    return images.to(dtype).permute(0, 3, 1, 2).contiguous()


class SimpleGenerator(nn.Module):
    """The reference's older single-head variant (counterpart of fenet's
    ``SimpleGenerator``): the same backbone and edge branch, then FC 2000 ->
    512 -> 1024 -> num_points·3 with LeakyReLU(0.01) and a final Tanh.
    ``forward(images) -> (B, num_points, 3)``. State_dict names as the
    Generator's: ``RepVGG.*``, ``edge0.*``, ``edge2.*``, ``linear``, ``fc1``
    ... ``fc3``."""

    def __init__(self, num_points: int = 1024, backbone: str = "RepVGG-A2"):
        super().__init__()
        self.num_points, self.backbone = num_points, backbone
        self.RepVGG = RepVGG(REPVGG_CONFIGS[backbone])
        self._edge = (EdgeBranch(),)
        for name, child in self._edge[0].named_children():
            self.add_module(name, child)
        self.fc1 = nn.Linear(2000, 512)
        self.fc2 = nn.Linear(512, 1024)
        self.fc3 = nn.Linear(1024, num_points * 3)
        self.register_buffer("edge_kernel", edge_kernel(), persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = _nchw(images, self.fc1.weight.dtype)
        h = torch.cat([self.RepVGG(x), self._edge[0](x, self.edge_kernel)], dim=1)
        h = F.leaky_relu(self.fc1(h), 0.01)
        h = F.leaky_relu(self.fc2(h), 0.01)
        return torch.tanh(self.fc3(h)).reshape(images.shape[0], self.num_points, 3)


def fold_generator_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A branched Generator's state_dict -> the state_dict of
    ``Generator(deploy=True)``: the RepVGG blocks through
    :func:`fold_repvgg_params`, and each edge conv's BN folded into it."""
    out = fold_repvgg_params(sd)
    for name in ("edge0", "edge2"):
        bn = f"{name}.1."
        out[f"{name}.0.weight"], out[f"{name}.0.bias"] = _fuse_conv_bn(
            out[f"{name}.0.weight"], *_bn(out, bn))
        for key in [k for k in out if k.startswith(bn)]:
            del out[key]
    return out


@torch.no_grad()
def to_deploy(model: Generator, dtype: Optional[torch.dtype] = None) -> Generator:
    """The serving form of ``model`` on its device, in eval mode: folded in
    float32 (the reference's ``repvgg_model_convert``, which no reference
    script calls), then, with ``dtype`` (e.g. ``torch.bfloat16``), every
    parameter and the edge kernel cast to it. The folded forward equals the
    branched eval forward to float32 rounding; a bf16 one computes in bf16
    end to end and returns bf16 clouds, ~1e-2 relative off the float32
    fold: for serving, not for metrics."""
    # Copies: the weights the fold passes through must not alias the model's.
    sd = {k: v.detach().to(torch.float32, copy=True) for k, v in model.state_dict().items()}
    arch = dict(num_points=model.num_points, backbone=model.backbone,
                fine_width=model.fine_width, mid_width=model.mid_width)
    deploy = deploy_from_state(arch, fold_generator_params(sd))
    return deploy.to(dtype=dtype).eval()


def deploy_from_state(arch: Mapping, sd: Mapping[str, torch.Tensor]) -> Generator:
    """``Generator(**arch, deploy=True)`` holding ``sd``'s tensors as they
    are, with no init: built on the meta device, the state assigned, and
    the edge kernel, which no state_dict holds, made beside them."""
    with torch.device("meta"):
        gen = Generator(**arch, deploy=True)
    gen.load_state_dict(sd, strict=True, assign=True)
    with torch.device(sd["fc1.weight"].device):
        gen.edge_kernel = edge_kernel()
    return gen


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill conv and linear weights and biases with U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) drawn from ``generator`` (on the model's device); reset
    BatchNorm to its identity (weight 1, bias 0, running mean 0, var 1)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model
