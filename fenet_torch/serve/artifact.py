"""Frozen serving artifact: the deploy-folded forward exported with
``torch.export`` (counterpart of ``fenet/serve/artifact.py``, which
serializes StableHLO with ``jax.export``).

One ``.pt2`` archive holds the program, raw uint8 pixels (b, H, W, 3) in and
the final (b, num_points, 3) cloud out, with a dynamic batch, and the folded
weights at their serving dtype. Serving it needs torch alone, not this
package's model code, and it cannot drift from the weights it was exported
with. The archive holds CPU tensors; :func:`load_artifact` moves the program
to its device, so the same file runs on the CPU and on a card, and one file
serves over several cards: one program a card, each replaying the same
one-device program on its shard of the batch (fenet replays its exported
program per shard under ``shard_map``).
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Optional, Tuple

import torch
from torch import nn

from fenet_torch.serve.server import device_forward, dtype_name, round_batch, serving_devices
from fenet_torch.utils.device import resolve_device

ARTIFACT_SUFFIX = ".pt2"


class _Cloud(nn.Module):
    """A generator's forward reduced to its final cloud."""

    def __init__(self, gen: nn.Module):
        super().__init__()
        self.gen = gen

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.gen(images)[2]


def export_artifact(deploy_model: nn.Module, out: str,
                    input_hw: Tuple[int, int] = (128, 128),
                    extra_meta: Optional[dict] = None) -> dict:
    """Export ``deploy_model`` (from ``models.generator.to_deploy``, at its
    serving dtype) to ``out`` with ``torch.export.save``, and write the
    ``out + '.json'`` sidecar; returns the sidecar's dict."""
    from torch.export import Dim, export
    from torch.export.passes import move_to_device_pass

    h, w = input_hw
    param = deploy_model.fc1.weight
    example = torch.zeros((2, h, w, 3), dtype=torch.uint8, device=param.device)
    program = export(_Cloud(deploy_model).eval(), (example,),
                     dynamic_shapes={"images": {0: Dim("b", min=1)}})
    program = move_to_device_pass(program, "cpu")
    torch.export.save(program, out)

    tensors = list(program.state_dict.values()) + [
        t for t in program.constants.values() if isinstance(t, torch.Tensor)]
    with zipfile.ZipFile(out) as z:
        program_bytes = sum(i.file_size for i in z.infolist() if "/models/" in i.filename)
    meta = {
        "format": "torch.export",
        "input": f"(b, {h}, {w}, 3) uint8 BHWC raw pixels",
        "output": f"(b, {deploy_model.num_points}, 3) {dtype_name(param.dtype)}",
        "num_points": int(deploy_model.num_points),
        "dtype": dtype_name(param.dtype),
        "program_bytes": program_bytes,
        "weight_bytes": int(sum(t.numel() * t.element_size() for t in tensors)),
        "n_params": int(sum(t.numel() for t in program.state_dict.values())),
        "bytes": os.path.getsize(out),
        "n_weights": len(tensors),
    }
    if extra_meta:
        meta.update(extra_meta)
    with open(out + ".json", "w") as f:
        json.dump(meta, f, indent=1, sort_keys=True)
    return meta


def load_artifact(path: str, device="cuda"):
    """(forward, meta): the artifact's program on ``device`` and its sidecar
    (empty if there is none). ``forward`` takes a (b, H, W, 3) uint8 numpy
    array or tensor and returns the (b, num_points, 3) cloud on ``device``.
    Needs torch alone."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    module = move_to_device_pass(torch.export.load(path), device).module()

    def forward(images) -> torch.Tensor:
        with torch.inference_mode():
            return module(torch.as_tensor(images, device=device))

    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return forward, meta


def build_forward_artifact(path: str, max_batch: int, device="cuda", devices=None):
    """(forward, meta) in ``serve.server.build_forward``'s contract, backed by
    a frozen artifact: the program moved to each device of
    ``serve.server.serving_devices`` (every visible card for ``cuda``), the
    batch split over them, ``max_batch`` rounded up to the device count."""
    devices = serving_devices(device, devices)
    programs = {d: load_artifact(path, d) for d in dict.fromkeys(devices)}
    meta = dict(next(iter(programs.values()))[1], max_batch=round_batch(max_batch, len(devices)),
                devices=len(devices), artifact=os.path.basename(path))
    return device_forward([programs[d][0] for d in devices], devices), meta
