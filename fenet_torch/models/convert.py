"""Weights into the port: fenet's JAX variables and the reference's
``.pth.tar`` checkpoints.

``state_dict_from_jax`` takes fenet's ``{"params", "batch_stats"}`` of a
``Generator`` or a ``SimpleGenerator`` as nested dicts of numpy arrays and
returns the port's state_dict, whose names are the reference's:

- conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw);
- Dense kernel (I, O) -> weight (O, I); a decoder ``conv*`` Dense, which is
  a Conv1d(k=1) in the reference, -> weight (O, C, 1);
- BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_BN_PARAMS = {"scale": "weight", "bias": "bias"}
_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping[str, Any], path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, path + (key,))
        else:
            yield path + (key,), value


def _module(path: Tuple[str, ...]) -> Optional[str]:
    """fenet module path -> the reference's torch module name."""
    top, rest = path[0], path[1:]
    if top == "RepVGG":
        if rest == ("linear",):
            return "RepVGG.linear"
        stage, branch = rest[0], rest[1]
        if "_" in stage:  # stage1_0 -> stage1.0 (a block of an nn.Sequential)
            stage = stage.replace("_", ".")
        if branch in ("rbr_identity", "rbr_reparam"):
            return f"RepVGG.{stage}.{branch}"
        if branch == "se":
            return f"RepVGG.{stage}.se.{rest[2]}"
        base, part = branch.rsplit("_", 1)  # rbr_dense_conv -> rbr_dense.conv
        return f"RepVGG.{stage}.{base}.{part}"
    if top == "edge":
        if rest == ("linear",):
            return "linear"
        name, kind = rest[0].rsplit("_", 1)  # edge0_conv -> edge0.0
        return f"{name}.{0 if kind == 'conv' else 1}"
    if top == "decoder":
        return rest[0]
    if top in ("fc1", "fc2", "fc3") and not rest:  # SimpleGenerator's head
        return top
    return None


def _is_bn(module_path: Tuple[str, ...]) -> bool:
    return module_path[-1].endswith("bn") or module_path[-1] == "rbr_identity"


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """fenet ``{"params", "batch_stats"}`` (numpy leaves) -> port state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables.get("params", {})):
        module = _module(path[:-1])
        if module is None:
            continue
        value = np.asarray(value, np.float32)
        leaf = path[-1]
        if _is_bn(path[:-1]):
            name, tensor = _BN_PARAMS[leaf], value
        elif leaf == "kernel" and value.ndim == 4:
            name, tensor = "weight", value.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and path[-2].startswith("conv"):
            name, tensor = "weight", value.T[:, :, None]
        elif leaf == "kernel":
            name, tensor = "weight", value.T
        else:
            name, tensor = "bias", value
        out[f"{module}.{name}"] = torch.tensor(tensor)
    for path, value in _leaves(variables.get("batch_stats", {})):
        module = _module(path[:-1])
        if module is not None:
            out[f"{module}.{_BN_STATS[path[-1]]}"] = torch.tensor(
                np.asarray(value, np.float32))
    return out


def load_reference_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load a reference ``.pth.tar`` (``{"state_dict": ...}``) into ``model``
    with ``strict=True``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(blob["state_dict"], strict=True)
    return model
