"""The port's training-evidence tools (``fenet_torch/tools/{equiv_common,
eps_scaling_equiv,sinkhorn_equiv,finetune_convergence}.py``) against
fenet's (``tools/*.py``): the batches byte for byte, the walls, and one arm
of training in each EMD mode; ``tests/test_torch_tools_records.py`` holds
the Sinkhorn tool's cross-eval, the finetune tool's sequence and the
records' keys.

Torch autograd and XLA:CPU corrupt the heap in one process, so the port's
training runs in a subprocess: this file run as a script (``python
tests/test_torch_tools.py <in.npz> <out.npz>``, which imports no JAX), for
both files. fenet's tools are imported by path, by these tests only.

Sizes: RepVGG-TEST with fine_width 32 (fenet's ``train_arm`` builds its
generator at the default widths, so the test hands it the small one), the
tools' 1024 points, batch 2, the auction at 50 iterations.

Tolerances. Step 0 of an arm is held at rtol 1e-4: both sides start from
the same weights on the same batch, so the losses differ only by the
forward's float32 rounding and, for Sinkhorn, the anneal's (~1e-6 and
~1e-5 measured). Later steps follow Adam updates, which move every weight
by about the LR whatever the gradient's size, so a gradient component near
0 that rounds to the other sign moves its weight by 2·LR differently: the
Sinkhorn mode's losses are held to 1e-3, and the auction modes to
``test_train_steps_match_fenet``'s rtol 5e-3·(step+1), with fenet's
assignments replayed (a 1e-7 change in a prediction lets the auction
resolve a near-tie the other way). The epoch moves 1 -> 3 over the three
steps (``steps_per_epoch`` 1); the LR stays the same below epoch 10.
"""

import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
BATCH, STEPS = 2, 3
EMD_ITERS = 50
ARM_MODES = {
    "auction": dict(emd_iters=EMD_ITERS),
    "adaptive": dict(emd_iters=EMD_ITERS, emd_scale_phases=3, emd_scale_thresh=0.3),
    "sinkhorn": dict(emd_impl="sinkhorn", sinkhorn_iters=30),
}
WARM, FINETUNE = 2, 2  # the finetune sequence's steps a phase
POINTS_SCORED = 256


def _replay(assignments) -> None:
    """Make the port's plain auction return ``assignments`` in turn."""
    from fenet_torch.ops import emd
    from fenet_torch.ops.pairwise import sqnorm

    recorded = iter(torch.tensor(a, dtype=torch.int32) for a in assignments)

    def replay(x1, x2, *args):
        ass = next(recorded)
        return sqnorm(x1 - x2.gather(1, ass.long()[..., None].expand(-1, -1, 3))), ass

    emd._auction_plain = replay


def _port(in_path: str, out_path: str) -> None:
    """The port's side, on the CPU: one arm of ``train_arm``, the finetune
    sequence (faithful then squash, and squash alone), or the three tools'
    records at a tiny size."""
    from fenet_torch.losses.facade import emd_loss
    from fenet_torch.tools import (equiv_common, eps_scaling_equiv, finetune_convergence,
                                   sinkhorn_equiv)
    from fenet_torch.train.config import TrainConfig

    blob = np.load(in_path)
    kind = str(blob["kind"])
    state_dict = {k[3:]: torch.tensor(blob[k]) for k in blob.files if k.startswith("sd.")}
    if kind == "arm":
        mode = str(blob["mode"])
        if "assignments" in blob.files:
            _replay(blob["assignments"])
        cfg = TrainConfig(batch_size=BATCH, **SMALL, **ARM_MODES[mode])
        batches, _ = equiv_common.make_batches(STEPS, BATCH)
        hist, _, _ = equiv_common.train_arm(cfg, batches, 1, mode, "cpu", state_dict)
        np.savez(out_path, losses=[[h[k] for k in ("total_loss", "chamfer_loss", "emd_loss")]
                                   for h in hist])
    elif kind == "finetune":
        images, points = finetune_convergence.fixed_batch(BATCH)
        cfg = TrainConfig(batch_size=BATCH, emd_iters=EMD_ITERS, **SMALL)
        out = {}
        for phases in (("faithful", "squash"), ("squash",)):
            _replay([a for phase in ("warm",) + phases for a in blob[f"ass_{phase}"]])
            traces = finetune_convergence.finetune_sequence(
                cfg, images, points, WARM, FINETUNE, "cpu", state_dict, phases)
            for phase, trace in traces.items():
                out[f"{'+'.join(phases)}.{phase}"] = [[s[k] for k in ("total", "cd", "emd")]
                                                      for s in trace]
        np.savez(out_path, **out)
    else:
        # The cross-eval's strict auction (3000 iterations) on an untrained
        # model's clouds runs all its iterations, ~75 s on the CPU: for the
        # records' keys it runs 50 here (score has its own test).
        sinkhorn_equiv.emd_loss = lambda pred, gt, eps, iters: emd_loss(pred, gt, eps, EMD_ITERS)
        tiny = dict(SMALL, emd_iters=EMD_ITERS, sinkhorn_iters=30)
        where = Path(out_path).parent
        common = ["--steps", "1", "--batch", str(BATCH), "--device", "cpu"]
        eps_scaling_equiv.run(common + ["--out", str(where / "eps.json")], **tiny)
        sinkhorn_equiv.run(common + ["--out", str(where / "sinkhorn.json")], **tiny)
        finetune_convergence.run(["--device", "cpu", "--out", str(where / "finetune.json")],
                                 warm_steps=1, finetune_steps=1, batch=BATCH, **tiny)
        np.savez(out_path, done=True)


if __name__ == "__main__":
    _port(sys.argv[1], sys.argv[2])
    raise SystemExit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

import fenet.models.generator as jax_generator  # noqa: E402
from fenet.ops.emd import earth_mover_distance as jax_emd  # noqa: E402
from fenet.parallel.mesh import make_mesh  # noqa: E402
from fenet.train.config import TrainConfig as JaxTrainConfig  # noqa: E402
from fenet.train.trainer import Trainer as JaxTrainer  # noqa: E402
from fenet_torch.models.convert import state_dict_from_jax  # noqa: E402
from fenet_torch.tools import equiv_common, finetune_convergence  # noqa: E402
from torch_tmp import remove_tmp_path  # noqa: E402,F401  (deletes each test's tmp_path)

ENV = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fenet_tool(name: str):
    """fenet's ``tools/<name>.py``, imported by path."""
    spec = importlib.util.spec_from_file_location(f"fenet_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def small_generator(monkeypatch):
    """fenet's Generator at the small widths, where fenet's tools build it
    by name (``Generator(num_points=1024, backbone=cfg.backbone)``)."""
    monkeypatch.setattr(jax_generator, "Generator",
                        functools.partial(jax_generator.Generator, **{
                            k: v for k, v in SMALL.items() if k != "backbone"}))


@pytest.fixture
def assignments(monkeypatch):
    """Record, before each of fenet's train steps in an auction mode, the
    assignment fenet's auction makes on that step's predictions (train-mode
    forward)."""
    recorded = []
    step = JaxTrainer.train_step

    def recording(self, state, images, points, epoch, lr):
        if self.config.emd_impl != "auction":
            return step(self, state, images, points, epoch=epoch, lr=lr)
        if not hasattr(self, "_assign"):
            cfg, model = self.config, self.model

            @jax.jit
            def assign(params, batch_stats, img, pt):
                (_, _, pc3), _ = model.apply({"params": params, "batch_stats": batch_stats},
                                             img, train=True, mutable=["batch_stats"])
                return jax_emd(pc3, pt, cfg.emd_eps, cfg.emd_iters, cfg.emd_scale_phases,
                               cfg.emd_early_exit, cfg.emd_scale_thresh)[1]

            self._assign = assign
        recorded.append(np.asarray(self._assign(state.params, state.batch_stats,
                                                jnp.asarray(images), jnp.asarray(points))))
        return step(self, state, images, points, epoch=epoch, lr=lr)

    monkeypatch.setattr(JaxTrainer, "train_step", recording)
    return recorded


def _fenet_init(cfg, num_points: int = 1024):
    """fenet's tools' init, ``Trainer.init_state(PRNGKey(0), ...)``, with
    the port's state_dict of it."""
    model = jax_generator.Generator(num_points=num_points, backbone=cfg.backbone)
    trainer = JaxTrainer(model, cfg, mesh=make_mesh(1))
    state = trainer.init_state(jax.random.PRNGKey(0), np.zeros((1, 128, 128, 3), np.float32))
    variables = jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                                    "batch_stats": state.batch_stats})
    return model, state, {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}


def _run_port(tmp_path, **blob):
    np.savez(tmp_path / "in.npz", **blob)
    subprocess.run([sys.executable, __file__, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, cwd=REPO, env=ENV, timeout=600)
    return np.load(tmp_path / "out.npz")


def test_make_batches_byte_equal_to_fenet():
    theirs = _fenet_tool("equiv_common")
    got, got_held = equiv_common.make_batches(2, 2)
    want, want_held = theirs.make_batches(2, 2)
    assert len(got) == len(want) == 2
    for (gi, gp), (wi, wp) in zip(got + [got_held], want + [want_held]):
        assert gi.dtype == wi.dtype == np.float32 and gp.dtype == wp.dtype == np.float32
        assert gi.tobytes() == wi.tobytes() and gp.tobytes() == wp.tobytes()
    # The finetune tool's one batch: images first, then clouds in [-0.45, 0.45).
    rng = np.random.RandomState(0)
    images = rng.rand(BATCH, 128, 128, 3).astype(np.float32) * 255
    points = (rng.rand(BATCH, 1024, 3).astype(np.float32) - 0.5) * 0.9
    ours = finetune_convergence.fixed_batch(BATCH)
    assert ours[0].tobytes() == images.tobytes() and ours[1].tobytes() == points.tobytes()


@pytest.mark.parametrize("walls", [[], [2.5], [9.0, 0.25, 0.5, 0.125]],
                         ids=["empty", "one", "many"])
def test_wall_sans_compile_matches_fenet(walls):
    assert (equiv_common.wall_sans_compile(walls)
            == _fenet_tool("equiv_common").wall_sans_compile(walls))


@pytest.mark.parametrize("mode", list(ARM_MODES))
def test_train_arm_matches_fenet(mode, tmp_path, small_generator, assignments):
    cfg = JaxTrainConfig(batch_size=BATCH, **SMALL, **ARM_MODES[mode])
    _, _, init = _fenet_init(cfg)
    batches, _ = _fenet_tool("equiv_common").make_batches(STEPS, BATCH)
    hist, _, _, _ = _fenet_tool("equiv_common").train_arm(cfg, batches, 1, mode)
    want = np.asarray([[h[k] for k in ("total_loss", "chamfer_loss", "emd_loss")]
                       for h in hist])
    replayed = {} if mode == "sinkhorn" else {"assignments": np.stack(assignments)}
    got = _run_port(tmp_path, kind="arm", mode=mode, **replayed,
                    **{f"sd.{k}": v for k, v in init.items()})["losses"]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, err_msg=f"{mode}: step 0")
    for step in range(1, STEPS):
        rtol = 1e-3 if mode == "sinkhorn" else 5e-3 * (step + 1)
        np.testing.assert_allclose(got[step], want[step], rtol=rtol,
                                   err_msg=f"{mode}: step {step}")
