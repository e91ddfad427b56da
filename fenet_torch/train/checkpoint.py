"""Checkpoints in two containers, with the reference's directory and
best-copy semantics (counterpart of ``fenet/train/checkpoint.py``).

- ``fmt="torch"`` (the port's default): the reference's ``.pth.tar``,
  ``{category}_checkpoint_{epoch}.pth.tar`` holding ``{"state_dict",
  "optimizer", "epoch", "train_time", "best_chamfer_loss", "best_emd_loss",
  "model_name"}``, the container fenet's ``export_torch_checkpoint`` writes
  and the reference's resume path reads.
- ``fmt="flax"``: fenet's own, ``{category}_checkpoint_{epoch}.ckpt``, the
  flax msgpack (:mod:`fenet_torch.train.flax_msgpack`) of ``{"batch_stats",
  "opt_state", "params"}`` in fenet's tree and layouts, with the scalars in
  a JSON sidecar ``<file>.json``. ``opt_state`` is optax's
  ``chain(add_decayed_weights, scale_by_adam)`` state, ``{"0": {}, "1":
  {"count", "mu", "nu"}}``: torch Adam's ``step``, ``exp_avg`` and
  ``exp_avg_sq`` (the same L2-in-the-gradient Adam), the moments in their
  parameters' fenet layouts. fenet reads these files and the port reads
  fenet's.

A best checkpoint is copied to ``model_best`` with the same suffix (and its
sidecar). :func:`load_checkpoint` tells the containers apart by suffix and
returns the port's blob either way: ``{"state_dict", "optimizer", ...the
scalars}``, on the CPU. A flax blob's optimizer groups hold only their
``params`` (fenet keeps no hyperparameters); the trainer that loads it
keeps its own. fenet's ``orbax`` container is not ported and raises.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import zipfile
from typing import Any, Dict, Optional

import numpy as np
import torch

from fenet_torch.models.convert import param_names, state_dict_from_jax, variables_from_state_dict
from fenet_torch.train import flax_msgpack

SUFFIX = ".pth.tar"
FLAX_SUFFIX = ".ckpt"
SUFFIXES = {"torch": SUFFIX, "flax": FLAX_SUFFIX}
BEST = "model_best" + SUFFIX
# The port's blob entries that are not scalars of the sidecar.
_ARRAYS = ("state_dict", "optimizer")


def check_format(fmt: str) -> None:
    if fmt == "orbax":
        raise NotImplementedError(
            "checkpoint format 'orbax' is not ported to fenet_torch: fenet's orbax "
            "directory is a tensorstore OCDBT store of zarr arrays, and reading it needs "
            "tensorstore. Write it across with fenet's flax container "
            "(--ckpt_format flax, a .ckpt file), which fenet_torch reads and writes")
    if fmt not in SUFFIXES:
        raise ValueError(f"unknown checkpoint format {fmt!r}; one of {sorted(SUFFIXES)}")


def _replace(src_write, path: str) -> None:
    """Write ``path`` through a temporary file: a crash mid-write leaves no
    truncated checkpoint, and a reader's mapping of the old file stays
    valid (the new file is a new inode)."""
    tmp = path + ".tmp"
    src_write(tmp)
    os.replace(tmp, path)


def _copy(src: str, dst: str) -> None:
    _replace(lambda tmp: shutil.copyfile(src, tmp), dst)


def save_checkpoint(state: Dict[str, Any], is_best: bool, category: str,
                    ckpt_dir: str, epoch: int, fmt: str = "torch") -> str:
    """Write ``state`` (state_dict, optimizer state and scalars) in the
    ``fmt`` container and, when ``is_best``, its ``model_best`` copy.
    Returns the file's path."""
    check_format(fmt)
    os.makedirs(ckpt_dir, exist_ok=True)
    suffix = SUFFIXES[fmt]
    path = os.path.join(ckpt_dir, f"{category}_checkpoint_{epoch}{suffix}")
    best = os.path.join(ckpt_dir, "model_best" + suffix)
    if fmt == "torch":
        _replace(lambda tmp: torch.save(state, tmp), path)
        if is_best:
            _copy(path, best)
        return path
    tree = flax_tree(state["state_dict"], state.get("optimizer"))
    _replace(lambda tmp: flax_msgpack.dump(tree, tmp), path)
    meta = {k: v for k, v in state.items() if k not in _ARRAYS}
    _replace(lambda tmp: _write_json(meta, tmp), path + ".json")
    if is_best:
        _copy(path, best)
        _copy(path + ".json", best + ".json")
    return path


def _write_json(meta: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint onto the CPU as the port's blob: a ``.pth.tar``
    as it is, a flax ``.ckpt`` converted (its arrays view the file, see
    :func:`flax_msgpack.load`), with its sidecar's scalars."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint not found: {path}; train the category first "
            "(checkpoints are written at the validation epochs, default "
            "10/30/50; see --validate_epochs)")
    if not path.endswith(FLAX_SUFFIX):
        return torch.load(path, map_location="cpu", weights_only=True)
    tree = flax_msgpack.load(path)
    blob = {"state_dict": state_dict_from_jax(tree)}
    if "opt_state" in tree:
        blob["optimizer"] = adam_from_optax(tree["opt_state"], blob["state_dict"])
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            blob.update(json.load(f))
    return blob


def checkpoint_epoch(path: str) -> int:
    """The epoch a checkpoint records (0 if none): from a ``.ckpt``'s
    sidecar, or a ``.pth.tar`` (mapped, its tensors unread, where it is in
    torch's zip format, which ``mmap`` needs; a legacy file is read)."""
    if path.endswith(FLAX_SUFFIX):
        if not os.path.exists(path + ".json"):
            return 0
        with open(path + ".json") as f:
            return int(json.load(f).get("epoch", 0))
    blob = torch.load(path, map_location="cpu", weights_only=True,
                      mmap=zipfile.is_zipfile(path))
    return int(blob.get("epoch", 0))


def latest_checkpoint(ckpt_dir: str, category: str,
                      suffix: str = SUFFIX) -> Optional[str]:
    """Path of the newest ``{category}_checkpoint_{epoch}{suffix}`` in
    ``ckpt_dir`` (highest epoch), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    pat = re.compile(re.escape(category) + r"_checkpoint_(\d+)" + re.escape(suffix) + r"$")
    best_epoch, best_path = -1, None
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch, best_path = int(m.group(1)), os.path.join(ckpt_dir, name)
    return best_path


def best_checkpoint(ckpt_dir: str) -> Optional[str]:
    """``ckpt_dir``'s ``model_best.pth.tar``, failing that its
    ``model_best.ckpt`` (fenet's), or None."""
    for suffix in (SUFFIX, FLAX_SUFFIX):
        path = os.path.join(ckpt_dir, "model_best" + suffix)
        if os.path.isfile(path):
            return path
    return None


# ---------------------------------------------------------------------------
# Adam's state <-> optax's chain(add_decayed_weights, scale_by_adam)
# ---------------------------------------------------------------------------


def flax_tree(state_dict: Dict[str, torch.Tensor], optimizer: Optional[Dict] = None
              ) -> Dict[str, Any]:
    """fenet's checkpoint tree of a port state_dict and, if given, its
    torch Adam state_dict (indexed in ``param_names`` order): ``count`` is
    the step (0 and zero moments where Adam holds no state yet, optax's
    init)."""
    tree = variables_from_state_dict(state_dict)
    if optimizer is None:
        return tree
    names = param_names(state_dict)
    per_param = optimizer["state"]
    steps = {float(entry["step"]) for entry in per_param.values()}
    if len(steps) > 1:
        raise ValueError(f"Adam's parameters are at different steps {sorted(steps)}; "
                         "optax keeps one count")
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        moments[key] = variables_from_state_dict({
            name: (per_param[i][key] if i in per_param else torch.zeros_like(state_dict[name]))
            for i, name in enumerate(names)})["params"]
    count = np.asarray(int(steps.pop()) if steps else 0, np.int32)
    tree["opt_state"] = {"0": {}, "1": {"count": count, "mu": moments["exp_avg"],
                                        "nu": moments["exp_avg_sq"]}}
    return tree


def adam_from_optax(opt_state: Dict[str, Any], state_dict: Dict[str, torch.Tensor]) -> Dict:
    """A torch Adam state_dict from fenet's ``opt_state``: ``step`` a
    float32 scalar, the moments in the port's layouts, indexed in
    ``param_names(state_dict)`` order; its one group holds only ``params``."""
    adam = opt_state["1"]
    mu = state_dict_from_jax({"params": adam["mu"]})
    nu = state_dict_from_jax({"params": adam["nu"]})
    step = float(np.asarray(adam["count"]))
    names = param_names(state_dict)
    state = {i: {"step": torch.tensor(step, dtype=torch.float32), "exp_avg": mu[name],
                 "exp_avg_sq": nu[name]} for i, name in enumerate(names)}
    return {"state": state, "param_groups": [{"params": list(range(len(names)))}]}
