"""Weights between the port and fenet's JAX variables, and the loader of
a checkpoint into a model.

``state_dict_from_jax`` takes fenet's ``{"params", "batch_stats"}`` of a
``Generator`` (branched or folded) or a ``SimpleGenerator`` as nested dicts
of numpy arrays (a bfloat16 leaf as a torch tensor) and returns the port's
state_dict, whose names are the reference's:

- conv kernel (kh, kw, I, O) -> weight (O, I, kh, kw);
- Dense kernel (I, O) -> weight (O, I); a decoder ``conv*`` Dense, which is
  a Conv1d(k=1) in the reference, -> weight (O, C, 1);
- BatchNorm scale/bias -> weight/bias; batch_stats mean/var ->
  running_mean/running_var.

``variables_from_state_dict`` is its inverse (fenet's
``torch_state_dict_to_variables``), with every map's keys sorted as in
fenet's trees, and ``param_names`` orders a state_dict's parameters as the
model registers them: the index torch's Adam numbers its state by.
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


def _tensor(value) -> Tuple[torch.Tensor, bool]:
    """(a leaf as a tensor, whether it is a private copy): numpy leaves as
    float32, sharing their memory where it is writable (a leaf of a mapped
    checkpoint); a bfloat16 leaf of a deploy file is the tensor it is."""
    if isinstance(value, torch.Tensor):
        return value, False
    value = np.asarray(value, np.float32)
    if value.flags.writeable:
        return torch.from_numpy(value), False
    return torch.from_numpy(value.copy()), True


def _owned(value, layout=lambda t: t) -> torch.Tensor:
    """A contiguous tensor of ``layout`` of the leaf that shares no memory
    with it: one copy (torch's, which blocks the transposes and runs on
    every intra-op thread), in the port's layout."""
    tensor, private = _tensor(value)
    tensor = layout(tensor)
    if private:
        return tensor.contiguous()
    return tensor.clone(memory_format=torch.contiguous_format)


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """fenet ``{"params", "batch_stats"}`` -> port state_dict: one
    contiguous copy of each leaf, in the port's layout."""
    out: Dict[str, torch.Tensor] = {}
    for path, value in _leaves(variables.get("params", {})):
        module = _module(path[:-1])
        if module is None:
            continue
        leaf = path[-1]
        layout = lambda t: t  # noqa: E731
        if _is_bn(path[:-1]):
            name = _BN_PARAMS[leaf]
        elif leaf == "kernel" and np.ndim(value) == 4:
            name, layout = "weight", lambda t: t.permute(3, 2, 0, 1)
        elif leaf == "kernel" and path[-2].startswith("conv"):
            name, layout = "weight", lambda t: t.T[:, :, None]
        elif leaf == "kernel":
            name, layout = "weight", lambda t: t.T
        else:
            name = "bias"
        out[f"{module}.{name}"] = _owned(value, layout)
    for path, value in _leaves(variables.get("batch_stats", {})):
        module = _module(path[:-1])
        if module is not None:
            out[f"{module}.{_BN_STATS[path[-1]]}"] = _owned(value)
    return out


def _jax_module(module: str, simple: bool) -> Tuple[str, ...]:
    """The reference's torch module name -> fenet's module path (the
    inverse of :func:`_module`); ``simple``: a SimpleGenerator, whose
    ``fc*`` head sits at the top."""
    parts = module.split(".")
    if parts[0] == "RepVGG":
        if parts[1] == "linear":
            return ("RepVGG", "linear")
        stage, rest = (parts[1], parts[2:]) if parts[1] == "stage0" else \
            (f"{parts[1]}_{parts[2]}", parts[3:])
        if rest[0] == "se":
            return ("RepVGG", stage, "se", rest[1])
        if rest[0] in ("rbr_identity", "rbr_reparam"):
            return ("RepVGG", stage, rest[0])
        return ("RepVGG", stage, f"{rest[0]}_{rest[1]}")  # rbr_dense.conv
    if parts[0] in ("edge0", "edge2"):
        return ("edge", f"{parts[0]}_{'conv' if parts[1] == '0' else 'bn'}")
    if parts[0] == "linear":
        return ("edge", "linear")
    return (parts[0],) if simple else ("decoder", parts[0])


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _sorted(tree):
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def _numpy(t: torch.Tensor):
    """A host C-contiguous leaf: numpy, or a torch tensor for bfloat16."""
    t = t.detach().cpu().contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def variables_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Port state_dict -> fenet ``{"params", "batch_stats"}`` in fenet's
    layouts, keys sorted, leaves host numpy (bfloat16: torch) at the
    tensors' dtype. ``num_batches_tracked``, which fenet does not keep, is
    dropped; an empty collection is left out."""
    simple = "fc1.weight" in state_dict and "fc1_1.weight" not in state_dict
    variables: Dict[str, Any] = {}
    for key, tensor in state_dict.items():
        module, leaf = key.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            continue
        path = _jax_module(module, simple)
        if leaf in ("running_mean", "running_var"):
            _set(variables, ("batch_stats",) + path + (leaf[len("running_"):],), _numpy(tensor))
            continue
        if _is_bn(path):
            name = {"weight": "scale", "bias": "bias"}[leaf]
        elif leaf == "weight":
            name = "kernel"
            if tensor.ndim == 4:  # (O, I, kh, kw) -> (kh, kw, I, O)
                tensor = tensor.permute(2, 3, 1, 0)
            elif tensor.ndim == 3:  # Conv1d (O, C, 1) -> Dense (C, O)
                tensor = tensor[:, :, 0].T
            else:  # Linear (O, I) -> Dense (I, O)
                tensor = tensor.T
        else:
            name = "bias"
        _set(variables, ("params",) + path + (name,), _numpy(tensor))
    return _sorted(variables)


# Registration order of the port's modules and leaves: each name's rank
# among its siblings (a digit part ranks by its number). The top level is
# RepVGG, edge0, edge2, linear, then the head; inside RepVGG the stages,
# then its linear.
_REGISTRATION = (
    "RepVGG", "edge0", "edge2", "stage0", "stage1", "stage2", "stage3", "stage4", "linear",
    "fc1", "fc2", "fc3", "fc1_1", "fc2_1", "fc3_1", "conv1_1", "conv1_2", "conv1_3",
    "conv2_1", "rbr_reparam", "rbr_dense", "rbr_1x1", "rbr_identity", "se", "down", "up",
    "conv", "bn", "weight", "bias",
)
_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def param_names(keys) -> list:
    """The parameter names among a Generator's, a folded Generator's or a
    SimpleGenerator's state_dict ``keys``, in ``model.named_parameters()``
    order."""
    rank = {name: i for i, name in enumerate(_REGISTRATION)}

    def order(key: str):
        return tuple((0, int(p)) if p.isdigit() else (1, rank[p]) for p in key.split("."))

    return sorted((k for k in keys if not k.endswith(_BUFFERS)), key=order)


def load_reference_checkpoint(model: nn.Module, path: str) -> nn.Module:
    """Load a checkpoint's weights into ``model`` with ``strict=True``: the
    reference's ``.pth.tar`` (``{"state_dict": ...}``) or fenet's flax
    ``.ckpt``, by its suffix (``fenet_torch.train.checkpoint``)."""
    from fenet_torch.train.checkpoint import load_checkpoint  # it imports this module

    model.load_state_dict(load_checkpoint(path)["state_dict"], strict=True)
    return model
