"""Checkpoints in the reference's ``.pth.tar`` container, with its directory
and best-copy semantics (counterpart of ``fenet/train/checkpoint.py``).

``save_checkpoint`` writes ``{category}_checkpoint_{epoch}.pth.tar`` holding
``{"state_dict", "optimizer", "epoch", "train_time", "best_chamfer_loss",
"best_emd_loss", "model_name"}``, the container fenet's
``export_torch_checkpoint`` writes and the reference's resume path reads,
and copies it to ``model_best.pth.tar`` when it is the best so far. fenet's
own "flax" and "orbax" containers are not ported and raise.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, Optional

import torch

SUFFIX = ".pth.tar"
BEST = "model_best" + SUFFIX


def check_format(fmt: str) -> None:
    if fmt != "torch":
        raise NotImplementedError(
            f"checkpoint format {fmt!r} is not ported to fenet_torch; it "
            "writes the reference's .pth.tar container (ckpt_format='torch')")


def save_checkpoint(state: Dict[str, Any], is_best: bool, category: str,
                    ckpt_dir: str, epoch: int, fmt: str = "torch") -> str:
    """Write ``state`` (state_dict, optimizer state and metadata) and, when
    ``is_best``, its ``model_best`` copy. Returns the file's path."""
    check_format(fmt)
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"{category}_checkpoint_{epoch}{SUFFIX}")
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)  # a crash mid-write leaves no truncated checkpoint
    if is_best:
        shutil.copyfile(path, os.path.join(ckpt_dir, BEST))
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a ``.pth.tar`` checkpoint onto the CPU."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint not found: {path}; train the category first "
            "(checkpoints are written at the validation epochs, default "
            "10/30/50; see --validate_epochs)")
    return torch.load(path, map_location="cpu", weights_only=True)


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
