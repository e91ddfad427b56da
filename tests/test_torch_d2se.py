"""RepVGG-D2se on the port's normal path against the benchmark's plain
reference (``portbench/reference/d2se.py``), and the count of its
squeeze-and-excite gates.

(a) At a small size on the CPU: D2se's 48 blocks at widths [0.25, 0.25,
0.25, 0.25] (entered in the port's registry as ``RepVGG-D2se-SMALL``), the
cmlp generator on it at 256 points, batch 2 of 128x128 images, on the
reference's seeded ``init`` loaded ``strict``: the train and eval forwards,
one ``Trainer`` step's loss, gradient and Adam update against the
reference's losses and ``Adam``, and the fold (``to_deploy``) against
``deploy_forward``. (b) At the published widths on meta tensors: the
parameter count and the FLOPs of ``counts/d2se.py``. (c) The span of each
gate. (d) The gates' counter (``se_work``). (e) The configuration loads.

Tolerances. Both sides run the same float32 operations in the same order
on the CPU (the reference's convolutions, BatchNorms and linears are the
port's modules' functional forms), so the forwards are held to 1e-6 of the
cloud's largest coordinate: room for a library that sums in another order,
a thousandth of what a TF32 operand moves them (~1e-3 relative, the
benchmark's control). The step: the loss to 1e-6 relative (one float32
rounding of a sum over 512 points, with the auction taking the same path on
the same predictions); each leaf's gradient to 1e-4 of the leaf's largest
element (a backward through 48 BatchNorms sums in another order than the
reference's autograd graph, which holds the identical equations; a TF32
operand moves them ~1e-2); each leaf's change over Adam's first step by
its norm, the benchmark's measure (``change3_leaf``: the gap over the larger
of the leaf's and the median leaf's norm), to 1e-4. Not element by element:
the first step moves a weight by about the LR whatever its gradient's size,
so an element whose gradient is rounding noise on both sides (0 behind a
ReLU on one, 1e-12 on the other) moves by anything up to the LR. The fold:
to 1e-5 of the largest coordinate, float32 rounding of the folded kernels'
sums (the port's fold is held to the same against its branched forward).

Torch autograd and XLA:CPU corrupt the heap when both run in one process
(conftest imports JAX), so everything that runs a backward runs in a
subprocess: this file run as a script (``python tests/test_torch_d2se.py
<out.json>``), which imports no JAX.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL_BACKBONE = "RepVGG-D2se-SMALL"
SMALL = dict(num_points=256, fine_width=32, mid_width=16)
BATCH, SEED, LR, WEIGHT_DECAY, EMD_ITERS = 2, 22, 5e-4, 1e-4, 200
BLOCKS = 48  # D2se's blocks, stage 0 included: one gate each
SE, BACKBONE = "fenet_torch.model.se", "fenet_torch.model.backbone"
# Each comparison of (a): its measure and its limit (the module docstring
# gives each limit's reason).
LIMITS = {"train_forward": 1e-6, "eval_forward": 1e-6, "step_loss": 1e-6, "step_grad": 1e-4,
          "step_change": 1e-4, "fold": 1e-5}
PUBLISHED = {"parameters": 282_364_212, "forward_gflop": 24.34, "train_gflop": 72.98,
             "deploy_gflop": 21.95}


def small_backbone():
    """D2se's depth and gates at widths [0.25] * 4, for the port's
    registry."""
    from fenet_torch.models.repvgg import REPVGG_CONFIGS

    return dataclasses.replace(REPVGG_CONFIGS["RepVGG-D2se"], width_multiplier=[0.25] * 4)


def small_config() -> dict:
    """``configs/d2se_1024.json`` at the small size."""
    from portbench import harness

    cfg = harness.load_config("d2se_1024")
    return dict(cfg, backbone=SMALL_BACKBONE, width_multiplier=[0.25] * 4, **SMALL)


def port_generator(cfg, state, deploy=False):
    from fenet_torch.models.generator import Generator

    gen = Generator(num_points=cfg["num_points"], backbone=cfg["backbone"],
                    fine_width=cfg["fine_width"], mid_width=cfg["mid_width"], deploy=deploy)
    gen.load_state_dict(state, strict=True)
    return gen


def batch():
    g = torch.Generator().manual_seed(SEED)
    images = torch.randint(0, 256, (BATCH, 128, 128, 3), dtype=torch.uint8, generator=g)
    points = torch.rand((BATCH, SMALL["num_points"], 3), generator=g) * 0.9
    return images, points


def _trainer(gen, cfg):
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer

    config = TrainConfig(batch_size=BATCH, num_points=cfg["num_points"], backbone=cfg["backbone"],
                         fine_width=cfg["fine_width"], mid_width=cfg["mid_width"], lr=LR,
                         weight_decay=WEIGHT_DECAY, emd_iters=EMD_ITERS)
    return Trainer(gen, config, loss_mode="schedule", device="cpu")


def _gap(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got - want).abs().max() / want.abs().max())


def _forwards(cfg, ref, state) -> dict:
    images, _ = batch()
    out = {}
    for name, train in (("eval_forward", False), ("train_forward", True)):
        gen = port_generator(cfg, state).train(train)
        with torch.no_grad():
            want = gen(images)
            got = ref.forward(state, images, cfg, train)
        out[name] = max(_gap(g, w) for g, w in zip(got, want))
    from fenet_torch.models.generator import to_deploy

    folded = ref.init(cfg, SEED + 1, "cpu", head_scale=0.03, random_bn=True)
    gen = port_generator(cfg, folded).eval()
    with torch.no_grad():
        want = to_deploy(gen)(images)[2]
    out["fold"] = _gap(ref.deploy_forward(ref.fold(folded, cfg), images, cfg), want)
    return out


def _step(cfg, ref, state) -> dict:
    """One Trainer step against the reference's loss, gradient and Adam."""
    from types import SimpleNamespace

    from portbench.reference.adam import Adam
    from portbench.reference.precision import FLOAT32
    from portbench.traffic import train as kind

    images, points = batch()
    gen = port_generator(cfg, state)
    trainer = _trainer(gen, cfg)
    loss = float(trainer.train_step(images, points, 1, LR)["total_loss"])
    named = dict(gen.named_parameters())

    ctx = SimpleNamespace(params={"reference_rows": BATCH, "emd_impl": "auction", "emd_eps": 0.05,
                                  "emd_iters": EMD_ITERS, "lambda_cd": 100.0,
                                  "lambda_emd": 100.0, "epoch": 1})
    params = {n: state[n].detach().clone().requires_grad_(True) for n in named}
    pred = ref.forward({**state, **params}, images, cfg, True)[2]
    want_loss, gpred = kind._loss_and_grad(ctx, pred.detach(), points, FLOAT32)
    grads = dict(zip(params, torch.autograd.grad(pred, list(params.values()), gpred)))
    Adam(LR, WEIGHT_DECAY).step({n: p.data for n, p in params.items()}, grads)
    return {
        "step_loss": abs(loss - want_loss) / abs(want_loss),
        "step_grad": max(_gap(named[n].grad, grads[n]) for n in named),
        "step_change": kind._worst_leaf(
            kind._norms({n: named[n].detach() - state[n] for n in named}),
            kind._norms({n: params[n].detach() - state[n] for n in named}), list(named)),
    }


def _counter(cfg, ref, state) -> dict:
    """One train step each: with no profiler, with the gate's plain forward
    in place of the counted one (the counter absent), and under a CPU
    profiler; what each counted and registered, and whether their losses
    and weights are the same bits."""
    from fenet_torch.models import repvgg

    images, points = batch()
    hooks = []
    real_hook = torch.Tensor.register_hook

    def counting_hook(tensor, fn):
        hooks.append(fn)
        return real_hook(tensor, fn)

    runs = {}
    for run in ("unprofiled", "absent", "profiled"):
        trainer = _trainer(port_generator(cfg, state), cfg)
        before = dict(repvgg.se_work("cpu"))
        hooks.clear()
        torch.Tensor.register_hook = counting_hook
        gate_forward = repvgg.SEBlock.forward
        if run == "absent":
            repvgg.SEBlock.forward = repvgg.SEBlock._gate
        try:
            if run == "profiled":
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                    stats = trainer.train_step(images, points, 1, LR)
            else:
                stats = trainer.train_step(images, points, 1, LR)
        finally:
            torch.Tensor.register_hook = real_hook
            repvgg.SEBlock.forward = gate_forward
        after = repvgg.se_work("cpu")
        runs[run] = {"counted": {k: after[k] - before[k] for k in after}, "hooks": len(hooks),
                     "stats": {k: v.detach().clone() for k, v in stats.items()},
                     "params": [p.detach().clone() for p in trainer.model.parameters()]}

    def same(a, b):
        return (all(torch.equal(a["stats"][k], b["stats"][k]) for k in a["stats"])
                and all(torch.equal(x, y) for x, y in zip(a["params"], b["params"])))

    return {run: {"counted": r["counted"], "hooks": r["hooks"],
                  "same_as_absent": same(r, runs["absent"])} for run, r in runs.items()}


def _published() -> dict:
    """Parameters and FLOPs a sample of the port's D2se generator at the
    published widths, on meta tensors, beside the reference's and the
    count's."""
    from torch.utils.flop_counter import FlopCounterMode

    from fenet_torch.models.generator import Generator
    from portbench import harness

    cfg = harness.load_config("d2se_1024")
    ref, count = harness.reference_module(cfg), harness.count_module(cfg)
    arch = dict(num_points=cfg["num_points"], backbone=cfg["backbone"],
                fine_width=cfg["fine_width"], mid_width=cfg["mid_width"])
    with torch.device("meta"):
        gen, deploy = Generator(**arch), Generator(**arch, deploy=True)
        images = torch.zeros((1, cfg["image_hw"], cfg["image_hw"], 3))
        with FlopCounterMode(display=False) as forward:
            gen(images)
        with FlopCounterMode(display=False) as train:
            gen(images)[2].sum().backward()
        with FlopCounterMode(display=False) as folded:
            deploy(images)
    return {
        "parameters": [sum(p.numel() for p in gen.parameters()), ref.parameter_count(cfg),
                       cfg["parameters"]],
        "names": sorted(n for n, _, _, _ in ref.spec(cfg)) == sorted(gen.state_dict()),
        "forward_flops": [forward.get_total_flops(), count.forward_flops(cfg)],
        "train_flops": [train.get_total_flops(), count.train_flops(cfg)],
        "deploy_flops": [folded.get_total_flops(), count.deploy_flops(cfg)],
    }


def _run(out_path: str) -> None:
    from fenet_torch.models import repvgg
    from portbench import harness

    torch.set_num_threads(1)
    repvgg.REPVGG_CONFIGS[SMALL_BACKBONE] = small_backbone()
    cfg = small_config()
    ref = harness.reference_module(cfg)
    state = ref.init(cfg, SEED, "cpu")
    out = {**_forwards(cfg, ref, state), **_step(cfg, ref, state),
           "counter": _counter(cfg, ref, state), "published": _published()}
    Path(out_path).write_text(json.dumps(out))


if __name__ == "__main__":
    _run(sys.argv[1])
    raise SystemExit(0)

import pytest  # noqa: E402


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    out = tmp_path_factory.mktemp("d2se") / "results.json"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    done = subprocess.run([sys.executable, __file__, str(out)], cwd=REPO, env=env,
                          timeout=600, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", list(LIMITS))
def test_small_d2se_matches_the_reference(results, name):
    """(a): each comparison within its limit (module docstring)."""
    assert results[name] <= LIMITS[name], (name, results[name])


@pytest.mark.parametrize("name", ["parameters", "names", "forward_flops", "train_flops",
                                  "deploy_flops"])
def test_published_d2se_counts(results, name):
    """(b): the port's parameters (282,364,212), the reference's state
    names, and each FLOP count against the flop counter on the port."""
    got = results["published"][name]
    if name == "names":
        assert got
        return
    assert len(set(got)) == 1, (name, got)
    if name == "parameters":
        assert got[0] == PUBLISHED["parameters"]
    else:
        assert round(got[0] / 1e9, 2) == PUBLISHED[name.replace("_flops", "_gflop")]


def test_gate_spans_nest_in_the_backbone(monkeypatch):
    """(c): one forward under a CPU profiler records a
    ``fenet_torch.model.se`` range a block, each inside
    ``fenet_torch.model.backbone``."""
    from fenet_torch.models import repvgg

    from portbench import harness

    monkeypatch.setitem(repvgg.REPVGG_CONFIGS, SMALL_BACKBONE, small_backbone())
    cfg = small_config()
    gen = port_generator(cfg, harness.reference_module(cfg).init(cfg, SEED, "cpu")).eval()
    images, _ = batch()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gen(images)
    gates = [e for e in prof.events() if e.name == SE]
    assert len(gates) == BLOCKS
    for e in gates:
        parent = e.cpu_parent
        while parent is not None and not parent.name.startswith("fenet_torch."):
            parent = parent.cpu_parent
        assert parent is not None and parent.name == BACKBONE


@pytest.mark.parametrize("run", ["unprofiled", "absent", "profiled"])
def test_gate_counter(results, run):
    """(d): under a profiler one step counts each gate's forward and
    backward once; with none it counts nothing and registers no hook; every
    step's losses and weights are those of the step without the counter,
    bit for bit."""
    got = results["counter"][run]
    calls = BLOCKS if run == "profiled" else 0
    assert got["counted"] == {"calls": calls, "backward_calls": calls, "ms": 0.0}
    assert got["hooks"] == 2 * calls
    assert got["same_as_absent"]


@pytest.mark.parametrize("module", ["reference", "counts"])
def test_d2se_config_loads_with_its_contracts(module):
    """(e): ``d2se_1024`` loads, its reference and count the ``d2se`` files,
    each keeping its folder's contract (``load_config`` refuses one that
    breaks it), and the file states the published widths, nothing cut."""
    from portbench import harness

    cfg = harness.load_config("d2se_1024")
    loaded = (harness.reference_module if module == "reference" else harness.count_module)(cfg)
    assert Path(loaded.__file__).name == "d2se.py"
    assert Path(loaded.__file__).parent.name == module
    assert (cfg["num_blocks"], cfg["width_multiplier"]) == ([8, 14, 24, 1], [2.5, 2.5, 2.5, 5])
    assert cfg["reduced"] == [] and cfg["parameters"] == PUBLISHED["parameters"]
