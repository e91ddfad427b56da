"""Write a trained checkpoint in its deploy-folded serving form
(counterpart of ``fenet/cli/export_deploy.py``): every RepVGG block and
edge conv folded into one biased conv (``models.generator.to_deploy``), at
float32 or bfloat16.

    python -m fenet_torch.cli.export_deploy --model out/%s/checkpoints/ \\
        --category 02828884 --dtype bfloat16 --format export

The input is ``{--model % category}/model_best.pth.tar`` (the reference's
container) or, where there is none, fenet's ``model_best.ckpt``, failing
that its ``model_best.orbax``, or a direct path to any of them (an orbax
checkpoint is a directory, as in fenet). fenet writes no deploy ``.orbax``,
so neither does this; :func:`load_deploy_checkpoint` reads one all the
same, as fenet's ``load_checkpoint`` would. ``--format torch`` writes the
folded state_dict with ``torch.save`` (default ``<ckpt_dir>/model_deploy.pth``) and a JSON sidecar
with the architecture and dtype, for :func:`load_deploy_checkpoint`;
``--format flax`` writes fenet's ``model_deploy.ckpt`` (``{"params"}`` of
the folded tree in fenet's layouts, flax msgpack) with fenet's sidecar,
which fenet's ``load_deploy_checkpoint`` and this one read;
``--format export`` writes a frozen ``torch.export`` program with its
weights (default ``<ckpt_dir>/model_deploy.pt2``, see ``serve.artifact``),
which serving loads with torch alone.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from fenet_torch.models.convert import (
    load_reference_checkpoint,
    state_dict_from_jax,
    variables_from_state_dict,
)
from fenet_torch.models.generator import Generator, deploy_from_state, to_deploy
from fenet_torch.train import flax_msgpack, orbax
from fenet_torch.train.checkpoint import BEST, FLAX_SUFFIX, best_checkpoint
from fenet_torch.utils.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_SIDECAR_KEYS = ("num_points", "backbone", "fine_width", "mid_width")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", type=str, default="./output/fenet/%s/checkpoints/",
                        help="checkpoint dir pattern (%%s = category) or a direct "
                             "path to a .pth.tar, a .ckpt or a .orbax directory")
    parser.add_argument("--category", type=str, default="02828884")
    parser.add_argument("--out", type=str, default=None,
                        help="output path; default <ckpt_dir>/model_deploy.pth "
                             "(.ckpt with --format flax, .pt2 with --format export)")
    parser.add_argument("--num_points", type=int, default=1024)
    parser.add_argument("--backbone", type=str, default="RepVGG-A2")
    parser.add_argument("--fine_width", type=int, default=512)
    parser.add_argument("--mid_width", type=int, default=128)
    parser.add_argument("--dtype", type=str, default="float32", choices=tuple(DTYPES),
                        help="serving precision of the folded weights; bfloat16 "
                             "runs the forward in bf16 at ~1e-2 relative "
                             "coordinate error (models.generator.to_deploy)")
    parser.add_argument("--format", type=str, default="torch",
                        choices=("torch", "flax", "export"),
                        help="torch: the folded state_dict, for "
                             "load_deploy_checkpoint (needs fenet_torch to "
                             "serve). flax: fenet's model_deploy.ckpt, which "
                             "fenet and fenet_torch both serve. export: a "
                             "torch.export program with its "
                             "weights, uint8 pixels in, cloud out, any batch "
                             "(serve.artifact; serving needs torch alone)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device the fold and the export run on")
    opt = parser.parse_args(argv)
    device = resolve_device(opt.device)

    path = opt.model % opt.category if "%s" in opt.model else opt.model
    if os.path.isdir(path):
        path = os.path.normpath(path)  # an orbax input's outputs go beside it
        if not orbax.is_container(path):
            path = best_checkpoint(path) or os.path.join(path, BEST)
    with torch.device(device):
        gen = Generator(num_points=opt.num_points, backbone=opt.backbone,
                        fine_width=opt.fine_width, mid_width=opt.mid_width)
    load_reference_checkpoint(gen, path)
    deploy = to_deploy(gen, DTYPES[opt.dtype])
    arch = {k: getattr(opt, k) for k in _SIDECAR_KEYS}

    if opt.format == "export":
        from fenet_torch.serve.artifact import ARTIFACT_SUFFIX, export_artifact

        out = opt.out or os.path.join(os.path.dirname(path), "model_deploy" + ARTIFACT_SUFFIX)
        meta = export_artifact(deploy, out, extra_meta={**arch, "source": path})
        print(json.dumps({"out": out, **meta}))
        return out

    if opt.format == "flax":
        out = opt.out or os.path.join(os.path.dirname(path), "model_deploy" + FLAX_SUFFIX)
        flax_msgpack.dump({"params": variables_from_state_dict(deploy.state_dict())["params"]},
                          out)
    else:
        out = opt.out or os.path.join(os.path.dirname(path), "model_deploy.pth")
        torch.save({k: v.cpu() for k, v in deploy.state_dict().items()}, out)
    meta = {"deploy": True, **arch, "dtype": opt.dtype, "source": path}
    with open(out + ".json", "w") as f:
        json.dump(meta, f)
    print(json.dumps({"out": out, **meta}))
    return out


def load_deploy_checkpoint(path: str, device="cuda"):
    """(deploy_model, dtype) from a checkpoint written with ``--format
    torch``, by its ``.ckpt`` suffix fenet's or the port's ``--format
    flax``, or an orbax directory of the same tree: the Generator rebuilt
    from the sidecar, in eval mode on ``device``, with no fold at load. Every weight is cast to the sidecar's
    dtype, so the model cannot serve at another dtype than the one
    returned."""
    device = resolve_device(device)
    with open(path + ".json") as f:
        meta = json.load(f)
    dtype = DTYPES[meta.get("dtype", "float32")]
    if os.path.isdir(path):
        state = state_dict_from_jax(orbax.load(path))
    elif path.endswith(FLAX_SUFFIX):
        state = state_dict_from_jax(flax_msgpack.load(path))
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    gen = deploy_from_state({k: meta[k] for k in _SIDECAR_KEYS},
                            {k: v.to(dtype) for k, v in state.items()})
    return gen.to(device=device, dtype=dtype).eval(), dtype


if __name__ == "__main__":
    main()
