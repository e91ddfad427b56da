"""One rank of ``chip_smoke.py``'s phase ``parallel``.

    python -m fenet_torch.tools.parallel_smoke <spec.json>

The spec (JSON) names this process's rank, the world, the coordinator's
port, the device and the model, and the cases to run in turn, each with
its own keys (where its inputs lie, where it writes). Each rank prints one
line ``RESULT {json}`` with every case's result and saves what the parent
compares bit for bit (gradients) under the spec's ``work`` directory; the
parent (``chip_smoke.py``) holds them against the one-process run on the
same card. One process runs several cases, since a process takes ~15 s to
start and reach the card. Cases:

- ``step`` (``dp`` ranks, gloo): this rank's rows of the saved batch, one
  train step from the seeded init, twice: left to its own auction, and
  replaying the one-process run's assignment (K3 still launches); saves
  both steps' compared gradients (GRAD_KEYS) and reports their losses and
  how the free auction's matching differs from the one-process run's on
  this rank's predictions; then 3 timed steps: step ms (host clock around
  synchronised work), the all-reduce's ms (``Trainer.all_reduce_``,
  synchronised around it) and the kernels' launches a step.
- ``train_net`` (gloo): ``train_net`` from the seeded init, fed from the
  written tree through ``ProcessShardDataset``; with ``resume`` a second
  run resumes from the first run's checkpoint. The launches and the
  DataLoader's native and declined batches of each run.
- ``nccl`` (world 1, joined through fenet's environment variables): one
  all-reduce, broadcast and all-gather of a CUDA tensor, then a one-step
  ``train_net``.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from fenet_torch.data import loader as data_loader
from fenet_torch.models.generator import Generator, init_random_
from fenet_torch.ops import chamfer, emd
from fenet_torch.ops.pairwise import sqnorm
from fenet_torch.parallel.distributed import finalize, initialize
from fenet_torch.parallel.mesh import transport
from fenet_torch.train.config import TrainConfig
from fenet_torch.train.trainer import Trainer

CAT = "02828884"
PG_TIMEOUT_S = 300
TIMED_STEPS = 3
# The gradients a step saves: the decoder's head, the first rows of
# fc1_1, and two backbone convs upstream of every sync-BN.
GRAD_KEYS = ("fc3_1.weight", "fc1_1.weight", "RepVGG.stage0.rbr_dense.conv.weight",
             "edge0.0.weight")


def launch_counts() -> dict:
    """As ``chip_smoke.launch_counts``: the auction's resident launches
    apart from its stream kernel's (K4)."""
    stream = emd.auction_kernel.stream_launches
    return {"chamfer_nn": chamfer.nn_kernel.launches,
            "emd_auction": emd.auction_kernel.launches - stream,
            "emd_auction_stream": stream}


def reset_counts() -> None:
    chamfer.nn_kernel.launches = 0
    emd.auction_kernel.launches = 0
    emd.auction_kernel.stream_launches = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def init_model(spec: dict, device: torch.device) -> Generator:
    """The generator of the spec, with the seeded init the parent uses."""
    with torch.device(device):
        gen = Generator(num_points=spec["n_points"], **spec["model"])
    return init_random_(gen, torch.Generator(device=device).manual_seed(spec["seed"]))


def _config(spec: dict, **kw) -> TrainConfig:
    """The spec's TrainConfig: its model, batch and points, and ``kw``."""
    return TrainConfig(batch_size=spec["batch"], num_points=spec["n_points"],
                       **spec["model"], **kw)


def _first_step(spec: dict, device: torch.device, images, points, assignment=None):
    """One train step of this rank from the seeded init: its losses, the
    GRAD_KEYS gradients (fc1_1's first ``grad_rows`` rows), its trainer and
    the (pred, gt) clouds its EMD term saw. With ``assignment`` the EMD term
    runs the auction as ever (the kernel launches and counts) but takes
    ``assignment`` as its matching: the step then uses the one-process
    run's, whatever near-ties the auction resolves otherwise on predictions
    ~1e-6 apart. The loss and its gradient are the EMD op's for a fixed
    assignment."""
    gen = init_model(spec, device)
    trainer = Trainer(gen, _config(spec, data_parallel=spec["dp"]), device=device)
    emd_term, seen = trainer.emd, []

    def hooked(pred, gt):
        seen.append((pred.detach().contiguous(), gt.detach().contiguous()))
        loss = emd_term(pred, gt)
        if assignment is None:
            return loss
        matched = gt.gather(1, assignment.to(device).long()[..., None].expand(-1, -1, 3))
        return torch.sqrt(sqnorm(pred - matched)).mean(dim=1).mean()

    trainer.emd = hooked
    stats = trainer.train_step(images, points, 1, spec["lr"])
    del trainer.emd  # back to the class's
    params = dict(gen.named_parameters())
    grads = {k: params[k].grad.cpu() for k in GRAD_KEYS}
    grads["fc1_1.weight"] = grads["fc1_1.weight"][:spec["grad_rows"]]
    return {k: float(v) for k, v in stats.items()}, grads, trainer, seen[0]


def matching_gap(trainer: Trainer, pred, gt, ref_assignment) -> dict:
    """How this rank's own auction matching of ``pred`` to ``gt`` differs
    from the one-process run's (``ref_assignment``, found on predictions
    ~1e-6 away): the share of assignment entries and of batch elements
    that differ, and each matching's mean squared cost on ``pred`` (the
    auction's units: two eps-optimal matchings of one problem are at most
    ``eps`` apart per element)."""
    cfg = trainer.config
    _, own = emd.earth_mover_distance(pred, gt, cfg.emd_eps, cfg.emd_iters,
                                      cfg.emd_scale_phases, cfg.emd_early_exit,
                                      cfg.emd_scale_thresh)
    ref = ref_assignment.to(pred.device)

    def cost(assignment):
        matched = gt.gather(1, assignment.long()[..., None].expand(-1, -1, 3))
        return sqnorm(pred - matched).mean(dim=1)

    c_own, c_ref = cost(own), cost(ref)
    differ = own != ref
    gap = (c_own - c_ref).abs()
    return {"differing_share": float(differ.float().mean()),
            "elements_differing": int(differ.any(dim=1).sum()), "elements": int(own.shape[0]),
            "cost_own_mean": float(c_own.mean()), "cost_one_process_mean": float(c_ref.mean()),
            "max_cost_gap": float(gap.max()), "eps": cfg.emd_eps,
            "within_eps": bool(gap.max() <= cfg.emd_eps)}


def case_step(spec: dict, device: torch.device) -> dict:
    """The step twice from the init, left to its own auction and replaying
    the one-process run's assignment (rows of this rank); then 3 timed
    steps."""
    dp, rank = spec["dp"], spec["rank"]
    blob = np.load(spec["inputs"])
    local = spec["batch"] // dp
    rows = slice(rank * local, (rank + 1) * local)
    images, points = blob["images"][rows], blob["points"][rows]
    ref_assignment = torch.as_tensor(blob["assignment"][rows])
    losses_free, grads_free, trainer, (pred, gt) = _first_step(spec, device, images, points)
    matching = matching_gap(trainer, pred, gt, ref_assignment)
    del trainer, pred, gt
    losses, grads, trainer, _ = _first_step(spec, device, images, points, ref_assignment)
    torch.save({"free": grads_free, "replayed": grads},
               Path(spec["work"]) / f"step_dp{dp}_rank{rank}.pt")

    all_reduce_ms = []
    reduce = trainer.all_reduce_

    def timed_reduce(step_stats):
        _sync(device)
        t0 = time.perf_counter()
        reduce(step_stats)
        _sync(device)
        all_reduce_ms.append((time.perf_counter() - t0) * 1e3)

    trainer.all_reduce_ = timed_reduce
    step_ms = []
    reset_counts()
    for _ in range(TIMED_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        out = trainer.train_step(images, points, 1, spec["lr"])
        float(out["total_loss"])  # synchronises
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = launch_counts()
    return {"losses": losses, "losses_free_auction": losses_free,
            "free_auction_matching": matching, "local_batch": local,
            "step_ms": step_ms, "all_reduce_ms": all_reduce_ms,
            "gradient_bytes": 4 * sum(p.numel() for p in trainer.model.parameters()),
            "launches_per_step": {k: v / TIMED_STEPS for k, v in launches.items()},
            "transport": transport(trainer.mesh.group, device)}


def _train_net(spec: dict, device: torch.device, **kw) -> dict:
    from fenet_torch.train.driver import train_net

    tree = spec["tree"]
    cfg = _config(spec, validate_epochs=tuple(spec["validate"]), manual_seed=spec["seed"],
                  train_save_freq=0, dir_path=spec["out"], splits_path=f"{tree}/splits",
                  data_dir_imgs=f"{tree}/ShapeNetRendering/",
                  data_dir_pcl=f"{tree}/ShapeNet_pointclouds/", **kw)
    reset_counts()
    data_loader.batch_counts.update(native=0, declined=0)
    _sync(device)
    t0 = time.perf_counter()
    out = train_net(CAT, cfg, model=init_model(spec, device), device=device)
    _sync(device)
    history = out["history"]
    for epoch in history:  # the clock's readings differ between ranks
        for key in ("wall_seconds", "samples_per_second"):
            epoch.get("val", {}).pop(key, None)
    if not all(math.isfinite(h[k]) for h in history for k in ("chamfer_loss", "emd_loss")):
        raise AssertionError(f"train_net losses are not finite: {history}")
    return {"wall_s": time.perf_counter() - t0, "launches": launch_counts(),
            "batch_counts": dict(data_loader.batch_counts), "history": history,
            "data_parallel": cfg.data_parallel}


def case_train_net(spec: dict, device: torch.device) -> dict:
    """One epoch; with ``resume`` a second run resumes from the checkpoint
    the first one's validation wrote (rank 0 loads it and broadcasts) and
    runs epoch 2."""
    runs = [_train_net(spec, device, nepoch=1)]
    if spec["resume"]:
        runs.append(_train_net(spec, device, nepoch=2, resume=True))
    return {"runs": runs}


def case_nccl(spec: dict, device: torch.device) -> dict:
    x = torch.arange(4.0, device=device)
    dist.all_reduce(x)
    y = torch.full((3,), 7.0, device=device)
    dist.broadcast(y, 0)
    parts = [torch.empty(2, device=device)]
    dist.all_gather(parts, torch.tensor([1.0, 2.0], device=device))
    if not (torch.equal(x.cpu(), torch.arange(4.0)) and torch.equal(y.cpu(), torch.full((3,), 7.0))
            and torch.equal(parts[0].cpu(), torch.tensor([1.0, 2.0]))):
        raise AssertionError("an NCCL collective of one rank changed its tensor")
    from fenet_torch.data.synthetic import SyntheticShapeNet
    from fenet_torch.train.driver import train_net

    # 144 samples: one step of 128.
    ds = SyntheticShapeNet(n_models=-(-spec["batch"] // 24), num_points=spec["n_points"],
                           variety=True, seed=0)
    cfg = _config(spec, nepoch=1, validate_epochs=(), train_save_freq=0,
                  manual_seed=spec["seed"], dir_path=spec["out"])
    reset_counts()
    out = train_net(CAT, cfg, ds, ds, model=init_model(spec, device), device=device)
    _sync(device)
    history = out["history"]
    if len(history) != 1 or not math.isfinite(history[0]["emd_loss"]):
        raise AssertionError(f"train_net under NCCL: {history}")
    return {"backend": dist.get_backend(), "world": dist.get_world_size(),
            "collectives": ["all_reduce", "broadcast", "all_gather"],
            "train_net_steps": len(ds) // spec["batch"], "launches": launch_counts(),
            "history": history}


CASES = {"step": case_step, "train_net": case_train_net, "nccl": case_nccl}


def main(argv=None) -> int:
    spec = json.loads(Path((argv or sys.argv[1:])[0]).read_text())
    names = [name for name, _ in spec["cases"]]
    if names == ["nccl"]:  # through the environment, as a launcher would
        initialize(backend="nccl", timeout_s=PG_TIMEOUT_S)
    else:
        initialize(f"127.0.0.1:{spec['port']}", spec["world"], spec["rank"], backend="gloo",
                   device=spec["device"], timeout_s=PG_TIMEOUT_S)
    device = torch.device(spec["device"])
    if device.type == "cuda":
        from fenet_torch.utils.device import full_fp32, resolve_device

        device = resolve_device("cuda")
        full_fp32()
    result = {"rank": spec["rank"]}
    for name, extra in spec["cases"]:
        result[name] = CASES[name]({**spec, **extra}, device)
    print("RESULT " + json.dumps(result), flush=True)
    finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
