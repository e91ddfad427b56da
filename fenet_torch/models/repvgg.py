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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from fenet_torch.ops.se_gate import se_gate
from fenet_torch.parallel.mesh import all_reduce_sum
from fenet_torch.utils.profiling import recording, span

_BN_EPS = 1e-5  # torch BatchNorm2d default, as in fenet
_BN_MOMENTUM = 0.1  # torch's convention for flax's momentum 0.9


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train mode updates the running statistics as
    flax's ``nn.BatchNorm`` does: with the biased batch variance.

    Stock ``BatchNorm2d`` updates ``running_var`` with the unbiased variance,
    n/(n-1) times larger (3.2% at a 4x4 map of batch 2), and would drift
    from fenet's ``batch_stats`` at every step. The output is stock train
    mode (batch mean and biased variance); eval mode is unchanged.

    With ``group`` set (sync-BN, fenet's ``axis_name``), train mode
    normalizes with the mean and biased variance of the whole batch over the
    group's ranks, and updates the running statistics from them: the
    single-device semantics at any data-parallel width. The statistics are
    combined differentiably (:func:`global_batch_stats`), so each rank's
    backward carries the other ranks' terms.
    """

    group = None  # a torch.distributed group: sync-BN over its ranks

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=_BN_EPS, momentum=_BN_MOMENTUM)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is None:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
                self._update_running(mean, var)
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        mean, var = global_batch_stats(x, self.group)
        with torch.no_grad():
            self._update_running(mean, var)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return ((x - mean[:, None, None]) * scale[:, None, None]) + self.bias[:, None, None]

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        keep = 1.0 - self.momentum
        self.running_mean.copy_(keep * self.running_mean + self.momentum * mean)
        self.running_var.copy_(keep * self.running_var + self.momentum * var)
        self.num_batches_tracked.add_(1)


def global_batch_stats(x: torch.Tensor, group) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance of NCHW ``x`` over the batches
    of every rank of ``group`` (equal batch sizes), differentiable.

    Each rank's mean and centred sum of squares are gathered in one
    all-reduce and combined as Chan et al.'s pairwise update does: the
    variance is a sum of centred terms, with no cancellation of
    E[x²] − E[x]² (fenet's rule, up to 1.1e-5 off at stage 0)."""
    ranks, me = dist.get_world_size(group), dist.get_rank(group)
    n = x.numel() // x.shape[1]
    mean = x.mean(dim=(0, 2, 3))
    m2 = (x - mean[:, None, None]).square().sum(dim=(0, 2, 3))
    own = torch.stack([mean, m2])
    slots = [own if r == me else torch.zeros_like(own) for r in range(ranks)]
    gathered = all_reduce_sum(torch.stack(slots), group)  # (ranks, 2, C)
    means, m2s = gathered[:, 0], gathered[:, 1]
    total_mean = means.mean(dim=0)
    total_m2 = m2s.sum(dim=0) + n * (means - total_mean).square().sum(dim=0)
    return total_mean, total_m2 / (n * ranks)


class SEBlock(nn.Module):
    """Squeeze-and-excite gate: x (B, C, h, w) scaled channel by channel by
    sigmoid(up(relu(down(mean over h, w of x)))), through
    :func:`fenet_torch.ops.se_gate.se_gate` (PyTorch's operations forward;
    backward its CUDA kernels on the card, its plain formulas on the CPU);
    ``down`` and ``up`` stay ``nn.Linear``.

    While a profiler records (:func:`recording`) each call is a
    ``fenet_torch.model.se`` span and is counted in :func:`se_work`;
    otherwise it runs the gate's operations alone: no span, hook or event.
    """

    def __init__(self, channels: int, internal: int):
        super().__init__()
        self.down = nn.Linear(channels, internal)
        self.up = nn.Linear(internal, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not recording():
            return self._gate(x)
        with span("fenet_torch.model.se"):
            return _counted(self._gate, x)

    def _gate(self, x: torch.Tensor) -> torch.Tensor:
        return se_gate(x, self.down.weight, self.down.bias, self.up.weight, self.up.bias)


class _GateWork:
    """One device's gate count: calls, backward calls, the device ms read so
    far and the CUDA event pairs not yet read."""

    def __init__(self):
        self.calls = self.backward_calls = 0
        self.ms = 0.0
        self.pending: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def add(self, start, end) -> None:
        if start is not None:
            self.pending.append((start, end))


def _mark(device: torch.device):
    """A timing event recorded now on ``device``'s current stream; None off
    CUDA."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _counted(gate, x: torch.Tensor) -> torch.Tensor:
    """``gate(x)`` counted in :func:`se_work`: its forward between two events
    around its launches; where it has a backward, one hook on the output
    that records an event as the output's gradient arrives, and one on the
    input that records the closing event once the input's gradient is
    whole (autograd runs the gate's nodes between the two, on their
    stream)."""
    work = se_work.totals.setdefault(x.device, _GateWork())
    start = _mark(x.device)
    out = gate(x)
    work.add(start, _mark(x.device))
    work.calls += 1
    if out.requires_grad and x.requires_grad:
        opened = []

        def begin(grad):
            opened.append(_mark(grad.device))

        def end(grad):
            work.backward_calls += 1
            work.add(opened.pop(), _mark(grad.device))

        out.register_hook(begin)
        x.register_hook(end)
    return out


def se_work(device) -> dict:
    """The squeeze-and-excite gates' work on ``device`` over the process's
    calls made while a profiler recorded: ``calls`` (forwards),
    ``backward_calls`` and ``ms``, the device milliseconds of them all.

    Each forward is timed by CUDA events recorded on its stream before and
    after its launches, each backward by events from the gate's output
    gradient to its input gradient; the time between a pair includes any
    idle time of the stream between the gate's kernels (the host launching
    late), and in the backward autograd's own steps between the gate's
    nodes. On the CPU the calls are counted and ``ms`` is 0. The events
    stay on the host until this reader synchronises the device once and
    sums them: not for the hot path."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    work = se_work.totals.get(device)
    if work is None:
        return {"calls": 0, "backward_calls": 0, "ms": 0.0}
    if work.pending:
        torch.cuda.synchronize(device)
        work.ms += sum(start.elapsed_time(end) for start, end in work.pending)
        work.pending.clear()
    return {"calls": work.calls, "backward_calls": work.backward_calls, "ms": work.ms}


se_work.totals = {}


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


def create_repvgg(name: str, deploy: bool = False) -> "RepVGG":
    """The backbone registered as ``name`` (the reference's
    get_RepVGG_func_by_name)."""
    return RepVGG(REPVGG_CONFIGS[name], deploy)


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

    def _blocks(self) -> List[Tuple[str, RepVGGBlock]]:
        """(fenet's block name, block) in order: ``stage0``, then
        ``stage{i}_{j}``, the j-th block of the ``stage{i}`` Sequential."""
        out = [("stage0", self.stage0)]
        for name, _, _, _ in _stage_plan(self.config)[1:]:
            stage, index = name.split("_")
            out.append((name, getattr(self, stage)[int(index)]))
        return out

    def block_names(self) -> List[str]:
        """Ordered block names: the valid Grad-CAM ``layer`` targets."""
        return [name for name, _, _, _ in _stage_plan(self.config)]

    def resolve_block(self, layer: str) -> str:
        """A layer spec as a block name: an exact block name, or a stage
        prefix ('stage2') meaning that stage's last block."""
        names = self.block_names()
        if layer in names:
            return layer
        in_stage = [n for n in names if n.startswith(layer + "_")]
        if in_stage:
            return in_stage[-1]
        raise ValueError(f"unknown layer {layer!r}; valid: {names} or a stage prefix")

    def features_up_to(self, x: torch.Tensor, layer: str) -> torch.Tensor:
        """The conv stages through block ``layer`` inclusive: the feature
        map Grad-CAM differentiates against."""
        layer = self.resolve_block(layer)
        for name, block in self._blocks():
            x = block(x)
            if name == layer:
                return x
        raise AssertionError(layer)  # unreachable after resolve_block

    def features_from(self, x: torch.Tensor, layer: str) -> torch.Tensor:
        """The conv stages after block ``layer`` -> the final feature map
        (the re-entry point for a mid-network CAM)."""
        layer = self.resolve_block(layer)
        seen = False
        for name, block in self._blocks():
            if seen:
                x = block(x)
            seen = seen or name == layer
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


def block_custom_l2(sd: Mapping[str, torch.Tensor], prefix: str = "") -> torch.Tensor:
    """The RepVGG custom weight-decay term of the branched block under
    ``prefix`` (the reference's ``get_custom_L2``): plain L2 on the 3x3
    kernel's ring, plus L2 of the BN-equivalent fused centre normalised by
    t3² + t1². The BN factors are detached, as the reference's."""
    k3 = sd[prefix + _BRANCH]
    k1 = sd[prefix + "rbr_1x1.conv.weight"]

    def factor(bn: str) -> torch.Tensor:
        t = sd[prefix + bn + "weight"] / torch.sqrt(sd[prefix + bn + "running_var"] + _BN_EPS)
        return t.detach()[:, None, None, None]

    t3, t1 = factor("rbr_dense.bn."), factor("rbr_1x1.bn.")
    centre = k3[:, :, 1:2, 1:2]
    l2_ring = (k3 ** 2).sum() - (centre ** 2).sum()
    eq_centre = centre * t3 + k1 * t1
    return (eq_centre ** 2 / (t3 ** 2 + t1 ** 2)).sum() + l2_ring


def model_custom_l2(model) -> torch.Tensor:
    """:func:`block_custom_l2` summed over every branched RepVGG block of a
    state_dict, or of a module (differentiable in its parameters)."""
    if isinstance(model, nn.Module):
        model = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    total = torch.zeros((), dtype=torch.float32)
    for key in model:
        if key.endswith(_BRANCH):
            total = total + block_custom_l2(model, key[:-len(_BRANCH)])
    return total


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
