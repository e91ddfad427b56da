"""The port's spans: one train step of the Trainer in each loss mode, under a
CPU profiler and without one.

Under a profiler every phase of the step is a ``fenet_torch.*`` range
nested as the trainer, generator, losses and ops open them, with torch's
own ``Optimizer.step`` range inside ``fenet_torch.train.optimizer``.
Without one ``span`` makes no range at all, and the step's losses and
weights are those of the profiled step bit for bit.

Torch autograd and XLA:CPU corrupt the heap when both run in one process
(conftest imports JAX), so the steps run in a subprocess: this file run as a
script (``python tests/test_torch_spans.py <out.json>``), which imports no
JAX.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
N_POINTS, BATCH = 256, 2
# (loss mode, TrainConfig overrides) of each case.
MODES = {
    "schedule_auction": ("schedule", dict(emd_iters=100)),
    "schedule_sinkhorn": ("schedule", dict(emd_impl="sinkhorn", sinkhorn_iters=20)),
    "finetune": ("finetune", dict(emd_iters=100)),
}
STEP, TRAIN, MODEL, LOSS = ("fenet_torch.train.step", "fenet_torch.train", "fenet_torch.model",
                            "fenet_torch.loss")
# Each span of a step -> the nearest fenet_torch span around it.
NESTING = {
    STEP: None,
    f"{TRAIN}.inputs": STEP,
    f"{TRAIN}.optimizer": STEP,
    f"{TRAIN}.forward": STEP,
    f"{MODEL}.backbone": f"{TRAIN}.forward",
    f"{MODEL}.edge": f"{TRAIN}.forward",
    f"{MODEL}.decoder": f"{TRAIN}.forward",
    f"{TRAIN}.loss": STEP,
    f"{LOSS}.chamfer": f"{TRAIN}.loss",
    f"{LOSS}.emd": f"{TRAIN}.loss",
    f"{TRAIN}.backward": STEP,
    "Optimizer.step": f"{TRAIN}.optimizer",
}
BY_MODE = {
    "schedule_auction": {"fenet_torch.ops.auction": f"{LOSS}.emd"},
    "schedule_sinkhorn": {"fenet_torch.ops.potentials": f"{LOSS}.emd",
                          "fenet_torch.sinkhorn.plan": f"{LOSS}.emd"},
    "finetune": {"fenet_torch.ops.auction": f"{LOSS}.emd", f"{LOSS}.bce": f"{TRAIN}.loss"},
}


def _nesting(events) -> dict:
    """{span name: the nearest fenet_torch span around it} of the
    profiler's events, for the fenet_torch spans and torch's Optimizer.step
    range (named ``Optimizer.step#Adam.step``)."""
    out = {}
    for e in events:
        name = e.name.split("#")[0]
        if not (name.startswith("fenet_torch.") or name == "Optimizer.step"):
            continue
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("fenet_torch."):
            parent = parent.cpu_parent
        seen = parent.name if parent is not None else None
        assert out.setdefault(name, seen) == seen, (name, seen, out[name])
    return out


def _steps(out_path: str) -> None:
    """One train step a mode from one seeded init and batch, without a
    profiler and under one: the spans each made, the nesting, and whether
    the two steps' losses and weights are the same bits."""
    from fenet_torch.models.generator import Generator, init_random_
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    images = (rng.rand(BATCH, 128, 128, 3) * 255).astype(np.uint8)
    points = (rng.rand(BATCH, N_POINTS, 3) * 0.9).astype(np.float32)
    real = torch.profiler.record_function
    out = {}
    for mode, (loss_mode, overrides) in MODES.items():
        runs = []
        for profiled in (False, True):
            gen = init_random_(Generator(num_points=N_POINTS, **SMALL),
                               torch.Generator().manual_seed(0))
            cfg = TrainConfig(batch_size=BATCH, num_points=N_POINTS, **SMALL, **overrides)
            trainer = Trainer(gen, cfg, loss_mode=loss_mode, device="cpu")
            made = []

            def counting(name, *args, made=made):
                made.append(name)
                return real(name, *args)

            torch.profiler.record_function = counting
            try:
                if profiled:
                    with torch.profiler.profile(
                            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                        stats = trainer.train_step(images, points, 1, 5e-4)
                    nesting = _nesting(prof.events())
                else:
                    stats = trainer.train_step(images, points, 1, 5e-4)
                    nesting = None
            finally:
                torch.profiler.record_function = real
            runs.append({"made": sorted({n for n in made if n.startswith("fenet_torch.")}),
                         "nesting": nesting,
                         "stats": {k: v.detach().clone() for k, v in stats.items()},
                         "params": [p.detach().clone() for p in gen.parameters()]})
        plain, traced = runs
        out[mode] = {
            "made_unprofiled": plain["made"], "made_profiled": traced["made"],
            "nesting": traced["nesting"],
            "same_stats": all(torch.equal(plain["stats"][k], traced["stats"][k])
                              for k in plain["stats"]),
            "same_params": all(torch.equal(a, b)
                               for a, b in zip(plain["params"], traced["params"])),
            "finite": all(bool(torch.isfinite(v)) for v in plain["stats"].values()),
        }
    Path(out_path).write_text(json.dumps(out))


if __name__ == "__main__":
    _steps(sys.argv[1])
    raise SystemExit(0)

import pytest  # noqa: E402


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    out = tmp_path_factory.mktemp("spans") / "steps.json"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    done = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, env=env,
                          timeout=600, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_spans_nest(steps, mode):
    """Under a profiler the step's phases are ranges nested as the table
    says, and torch's Adam range lies inside the optimizer's span."""
    want = dict(NESTING, **BY_MODE[mode])
    assert steps[mode]["nesting"] == want
    assert steps[mode]["made_profiled"] == sorted(n for n in want if n.startswith("fenet_"))


@pytest.mark.parametrize("mode", list(MODES))
def test_no_profiler_no_span_and_the_same_step(steps, mode):
    """Without a profiler no span makes a range, and the step's losses and
    weights are the profiled step's bit for bit."""
    run = steps[mode]
    assert run["made_unprofiled"] == [] and run["finite"]
    assert run["same_stats"] and run["same_params"]
