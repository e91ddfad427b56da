"""Tensor parallelism (Megatron) of the decoder's heads (counterpart of
``fenet/parallel/tp.py``).

The decoder's fine head is one fully connected pair, ``fc1_1`` (1024 →
256·fine_width, 134M parameters at the reference's 512: ~80% of the model)
then the per-point ``conv1_1`` (fine_width → fine_width). The mid head's
``fc2_1``/``conv2_1`` pair is the same shape of split (8.4M parameters).
Over the ``tp`` ranks of a mesh row:

- ``fc1_1``/``fc2_1`` are column-parallel: rank t holds rows
  ``[t·R, (t+1)·R)`` of ``weight`` (out, in) and of ``bias``. The
  (fine_width, 256) reshape after it is channel-major
  (``fenet_torch/models/generator.py``), so a contiguous row block is a
  contiguous block of whole channels.
- ``conv1_1``/``conv2_1`` are row-parallel: rank t holds the same channels
  of dim 1 of ``weight`` (out, in, 1); the partial outputs are summed over
  the group and the bias, whole on every rank, is added once after.

:data:`RULES` names the split dimension of each sharded state_dict entry;
the same rule shards the parameters and their Adam moments. Checkpoints
hold the full tensors (:func:`full_state_dict`, :func:`full_optimizer_state`),
so a tensor-parallel checkpoint loads into a one-process model with
``strict=True``, and the other way round.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch import nn

from fenet_torch.parallel.mesh import Mesh, all_gather

# state_dict name -> the dimension its tensor is split along.
RULES = {
    "fc1_1.weight": 0,
    "fc1_1.bias": 0,
    "fc2_1.weight": 0,
    "fc2_1.bias": 0,
    "conv1_1.weight": 1,
    "conv2_1.weight": 1,
}
# Adam's per-parameter tensors that mirror the parameter's shape.
MOMENTS = ("exp_avg", "exp_avg_sq")


def shard_tensor(full: torch.Tensor, dim: int, tp: int, index: int) -> torch.Tensor:
    """Block ``index`` of ``tp`` equal blocks of ``full`` along ``dim``."""
    if full.shape[dim] % tp:
        raise ValueError(f"dimension {dim} of a {tuple(full.shape)} tensor does not split "
                         f"over {tp} tensor-parallel ranks")
    return full.chunk(tp, dim)[index].clone()


def shard_state_dict(state: Dict[str, torch.Tensor], tp: int, index: int
                     ) -> Dict[str, torch.Tensor]:
    """A full state_dict -> rank ``index``'s."""
    return {k: shard_tensor(v, RULES[k], tp, index) if k in RULES else v
            for k, v in state.items()}


def shard_model_(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Replace ``model``'s Megatron parameters by this rank's blocks, in
    place (the parameters keep their order), and run the decoder's heads
    under ``mesh.tp_group``. Make the optimizer after this."""
    if mesh.tp == 1:
        return model
    widths = (model.fine_width, model.mid_width)
    if any(w % mesh.tp for w in widths):
        raise ValueError(f"fine_width/mid_width {widths} do not split over "
                         f"{mesh.tp} tensor-parallel ranks")
    with torch.no_grad():
        for name, dim in RULES.items():
            owner, attr = name.rsplit(".", 1)
            module = model.get_submodule(owner)
            full = getattr(module, attr)
            setattr(module, attr, nn.Parameter(
                shard_tensor(full.detach(), dim, mesh.tp, mesh.tp_index)))
    model.decoder.tp_group = mesh.tp_group
    return model


def _gather(shard: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    return torch.cat(all_gather(shard.contiguous(), mesh.tp_group), dim)


def full_state_dict(model: nn.Module, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with the Megatron entries gathered whole. A
    collective: every rank of the tensor-parallel group calls it."""
    state = model.state_dict()
    if mesh.tp > 1:
        for name, dim in RULES.items():
            state[name] = _gather(state[name], dim, mesh)
    return state


def _param_names(model: nn.Module) -> List[str]:
    """The state_dict name of each optimizer parameter index (Adam numbers
    its state by the order of ``model.parameters()``)."""
    return [name for name, _ in model.named_parameters()]


def full_optimizer_state(state: Dict[str, Any], model: nn.Module, mesh: Mesh
                         ) -> Dict[str, Any]:
    """An optimizer state_dict of the sharded model with each Megatron
    parameter's moments gathered whole (a collective, as above)."""
    if mesh.tp == 1:
        return state
    per_param = dict(state["state"])
    for i, name in enumerate(_param_names(model)):
        if name in RULES and i in per_param:
            entry = dict(per_param[i])
            for key in MOMENTS:
                entry[key] = _gather(entry[key], RULES[name], mesh)
            per_param[i] = entry
    return {**state, "state": per_param}


def shard_optimizer_state(state: Dict[str, Any], model: nn.Module, mesh: Mesh
                          ) -> Dict[str, Any]:
    """A full optimizer state_dict -> this rank's (the Megatron
    parameters' moments cut to their blocks)."""
    if mesh.tp == 1:
        return state
    per_param = dict(state["state"])
    for i, name in enumerate(_param_names(model)):
        if name in RULES and i in per_param:
            entry = dict(per_param[i])
            for key in MOMENTS:
                entry[key] = shard_tensor(entry[key], RULES[name], mesh.tp, mesh.tp_index)
            per_param[i] = entry
    return {**state, "state": per_param}
