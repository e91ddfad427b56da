"""RepVGG backbone in PyTorch (counterpart of ``fenet/models/repvgg.py``):
the branched (train-time) form in eval or train mode, and the deploy form,
one biased 3x3 conv a block, with the fold between them as a pure function
on state_dicts (:func:`fold_repvgg_params`).

Module names follow the reference state_dict
(``RepVGG.stage1.0.rbr_dense.conv.weight``, ``RepVGG.stage0.rbr_identity``,
``RepVGG.linear``; deploy: ``RepVGG.stage1.0.rbr_reparam``, the name of the
reference's ``switch_to_deploy``), so a reference ``.pth.tar`` loads with
``strict=True``. Layout is NCHW inside; the generator permutes its NHWC
input once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-5  # torch BatchNorm2d default, as in fenet
_BN_MOMENTUM = 0.1  # torch's convention for flax's momentum 0.9


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running statistics as
    flax's ``nn.BatchNorm`` does: with the biased batch variance.

    Stock ``BatchNorm2d`` updates ``running_var`` with the unbiased variance,
    n/(n-1) times larger (3.2% at a 4x4 map of batch 2), and would drift
    from fenet's ``batch_stats`` at every step. The output is stock train
    mode (batch mean and biased variance); eval mode is unchanged.
    """

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=_BN_EPS, momentum=_BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            keep = 1.0 - self.momentum
            self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
            self.running_var.copy_(keep * self.running_var + self.momentum * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class SEBlock(nn.Module):
    """Squeeze-and-excite gate."""

    def __init__(self, channels: int, internal: int):
        super().__init__()
        self.down = nn.Linear(channels, internal)
        self.up = nn.Linear(internal, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = x.mean(dim=(2, 3))
        w = torch.sigmoid(self.up(torch.relu(self.down(w))))
        return x * w[:, :, None, None]


def _conv_bn(cin: int, cout: int, kernel: int, stride: int, padding: int,
             groups: int) -> nn.Sequential:
    seq = nn.Sequential()
    seq.add_module("conv", nn.Conv2d(cin, cout, kernel, stride, padding,
                                     groups=groups, bias=False))
    seq.add_module("bn", BatchNorm2d(cout))
    return seq


class RepVGGBlock(nn.Module):
    """conv3x3+BN || conv1x1+BN || identity BN, summed, optional SE, ReLU;
    with ``deploy=True`` one biased 3x3 conv (``rbr_reparam``) in place of
    the branches."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 groups: int = 1, use_se: bool = False, deploy: bool = False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.rbr_reparam = nn.Conv2d(in_channels, out_channels, 3, stride, 1,
                                         groups=groups, bias=True)
        else:
            self.rbr_dense = _conv_bn(in_channels, out_channels, 3, stride, 1, groups)
            self.rbr_1x1 = _conv_bn(in_channels, out_channels, 1, stride, 0, groups)
            self.rbr_identity = (
                BatchNorm2d(in_channels)
                if in_channels == out_channels and stride == 1 else None
            )
        self.se = SEBlock(out_channels, out_channels // 16) if use_se else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.deploy:
            out = self.rbr_reparam(x)
        else:
            out = self.rbr_dense(x) + self.rbr_1x1(x)
            if self.rbr_identity is not None:
                out = out + self.rbr_identity(x)
        if self.se is not None:
            out = self.se(out)
        return torch.relu(out)


@dataclasses.dataclass(frozen=True)
class RepVGGConfig:
    num_blocks: Sequence[int]
    width_multiplier: Sequence[float]
    override_groups_map: Mapping[int, int] = dataclasses.field(default_factory=dict)
    use_se: bool = False
    num_classes: int = 1000


_G_LAYERS = (2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26)
_G2 = {layer: 2 for layer in _G_LAYERS}
_G4 = {layer: 4 for layer in _G_LAYERS}

REPVGG_CONFIGS: Dict[str, RepVGGConfig] = {
    "RepVGG-A0": RepVGGConfig([2, 4, 14, 1], [0.75, 0.75, 0.75, 2.5]),
    "RepVGG-A1": RepVGGConfig([2, 4, 14, 1], [1, 1, 1, 2.5]),
    "RepVGG-A2": RepVGGConfig([2, 4, 14, 1], [1.5, 1.5, 1.5, 2.75]),
    "RepVGG-B0": RepVGGConfig([4, 6, 16, 1], [1, 1, 1, 2.5]),
    "RepVGG-B1": RepVGGConfig([4, 6, 16, 1], [2, 2, 2, 4]),
    "RepVGG-B1g2": RepVGGConfig([4, 6, 16, 1], [2, 2, 2, 4], _G2),
    "RepVGG-B1g4": RepVGGConfig([4, 6, 16, 1], [2, 2, 2, 4], _G4),
    "RepVGG-B2": RepVGGConfig([4, 6, 16, 1], [2.5, 2.5, 2.5, 5]),
    "RepVGG-B2g2": RepVGGConfig([4, 6, 16, 1], [2.5, 2.5, 2.5, 5], _G2),
    "RepVGG-B2g4": RepVGGConfig([4, 6, 16, 1], [2.5, 2.5, 2.5, 5], _G4),
    "RepVGG-B3": RepVGGConfig([4, 6, 16, 1], [3, 3, 3, 5]),
    "RepVGG-B3g2": RepVGGConfig([4, 6, 16, 1], [3, 3, 3, 5], _G2),
    "RepVGG-B3g4": RepVGGConfig([4, 6, 16, 1], [3, 3, 3, 5], _G4),
    "RepVGG-D2se": RepVGGConfig([8, 14, 24, 1], [2.5, 2.5, 2.5, 5], use_se=True),
    # A miniature config for fast CPU tests.
    "RepVGG-TEST": RepVGGConfig([1, 1, 1, 1], [0.25, 0.25, 0.25, 0.25]),
}


def _stage_plan(config: RepVGGConfig) -> List[Tuple[str, int, int, int]]:
    """(name, out_channels, stride, groups) for every block, in order."""
    wm = config.width_multiplier
    in_planes = min(64, int(64 * wm[0]))
    plan = [("stage0", in_planes, 2, 1)]
    layer_idx = 1
    widths = [int(64 * wm[0]), int(128 * wm[1]), int(256 * wm[2]),
              int(512 * wm[3])]
    for stage_i, (planes, blocks) in enumerate(zip(widths, config.num_blocks), start=1):
        for block_i, stride in enumerate([2] + [1] * (blocks - 1)):
            groups = config.override_groups_map.get(layer_idx, 1)
            plan.append((f"stage{stage_i}_{block_i}", planes, stride, groups))
            layer_idx += 1
    return plan


class RepVGG(nn.Module):
    """stage0 + four stages + global average pool + linear classifier;
    ``deploy=True`` builds every block in its folded form."""

    def __init__(self, config: RepVGGConfig, deploy: bool = False):
        super().__init__()
        self.config = config
        stages: Dict[str, List[RepVGGBlock]] = {}
        in_ch = 3
        for name, planes, stride, groups in _stage_plan(config):
            block = RepVGGBlock(in_ch, planes, stride, groups, config.use_se, deploy)
            stages.setdefault(name.split("_")[0], []).append(block)
            in_ch = planes
        self.stage0 = stages.pop("stage0")[0]
        for name, blocks in stages.items():
            self.add_module(name, nn.Sequential(*blocks))
        self.linear = nn.Linear(in_ch, config.num_classes)

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """Conv stages only: (B, 3, H, W) -> final (B, C, h, w) feature map."""
        x = self.stage0(x)
        for name in ("stage1", "stage2", "stage3", "stage4"):
            x = getattr(self, name)(x)
        return x

    def head(self, feature_map: torch.Tensor) -> torch.Tensor:
        """Global average pool + classifier."""
        return self.linear(feature_map.mean(dim=(2, 3)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.forward_features(x))


# ---------------------------------------------------------------------------
# Structural reparameterization as a pure function on state_dicts
# ---------------------------------------------------------------------------

_BRANCH = "rbr_dense.conv.weight"


def _fuse_conv_bn(weight: torch.Tensor, bn_weight: torch.Tensor, bn_bias: torch.Tensor,
                  mean: torch.Tensor, var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN's statistics folded into a conv's (O, I/g, kh, kw) weight and a bias."""
    t = bn_weight / torch.sqrt(var + _BN_EPS)
    return weight * t[:, None, None, None], bn_bias - mean * t


def _dirac_kernel(channels: int, groups: int, like: torch.Tensor) -> torch.Tensor:
    """The identity as a 3x3 kernel in (O, I/groups, 3, 3) layout."""
    input_dim = channels // groups
    k = torch.zeros(channels, input_dim, 3, 3, dtype=like.dtype, device=like.device)
    o = torch.arange(channels, device=like.device)
    k[o, o % input_dim, 1, 1] = 1.0
    return k


def _bn(sd: Mapping[str, torch.Tensor], prefix: str):
    return tuple(sd[prefix + leaf] for leaf in ("weight", "bias", "running_mean", "running_var"))


def fold_block(sd: Mapping[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """One branched block's entries under ``prefix`` -> its deploy entries,
    ``rbr_reparam.{weight,bias}`` and the SE gate's unchanged (the
    reference's ``get_equivalent_kernel_bias``).

    The identity branch's group count is read from the block's own 3x3
    conv: it exists only where in == out channels, so groups = O / (I/g).
    """
    w3 = sd[prefix + _BRANCH]
    k3, b3 = _fuse_conv_bn(w3, *_bn(sd, prefix + "rbr_dense.bn."))
    k1, b1 = _fuse_conv_bn(sd[prefix + "rbr_1x1.conv.weight"], *_bn(sd, prefix + "rbr_1x1.bn."))
    kernel = k3 + F.pad(k1, (1, 1, 1, 1))
    bias = b3 + b1
    if prefix + "rbr_identity.weight" in sd:
        channels = w3.shape[0]
        kid, bid = _fuse_conv_bn(_dirac_kernel(channels, channels // w3.shape[1], w3),
                                 *_bn(sd, prefix + "rbr_identity."))
        kernel = kernel + kid
        bias = bias + bid
    out = {prefix + "rbr_reparam.weight": kernel, prefix + "rbr_reparam.bias": bias}
    out.update({k: v for k, v in sd.items() if k.startswith(prefix + "se.")})
    return out


def fold_repvgg_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state_dict holding branched RepVGG blocks -> the state_dict of the
    same modules with ``deploy=True`` (the reference's
    ``repvgg_model_convert`` as a pure function); every entry outside the
    blocks passes through unchanged."""
    prefixes = [k[:-len(_BRANCH)] for k in sd if k.endswith(_BRANCH)]
    branches = ("rbr_dense.", "rbr_1x1.", "rbr_identity.", "se.")
    out = {k: v for k, v in sd.items()
           if not any(k.startswith(p + b) for p in prefixes for b in branches)}
    for prefix in prefixes:
        out.update(fold_block(sd, prefix))
    return out
