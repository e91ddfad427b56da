"""The fenet_torch training slice against fenet's: the train-mode generator
and its BatchNorm statistics, three train steps of the Trainer in each EMD
mode, the config, the LR schedule, the meter, the options that raise, and
train_net with the CLI on a synthetic tree.

Torch autograd and XLA:CPU corrupt the heap when both run in one process, so
everything that runs a torch backward runs in a subprocess: the train steps
come from this file run as a script (``python tests/test_torch_train.py
<in.npz> <out.npz>``, which imports no JAX), and train_net from the CLI.

Tolerances. The train-mode forward: as eval (rtol 1e-4, atol 1e-3 on outputs
of magnitude ~100; the convolution libraries sum in other orders). Running
statistics: to 1e-6 relative (and 1e-6 absolute near 0) against flax's
update rule evaluated in float64 on the port's own BatchNorm inputs (measured
within 1e-7 on every layer), and to 1e-6 against fenet's batch_stats, except
at stage 0. Its BatchNorms see raw 0..255 pixels through one convolution
(variances ~1e2-1e3 over 8,192 values a channel), where fenet's float32
E[x²] - E[x]² is itself up to 1.1e-5 off the float64 value (measured on
this init): stage 0 is held to fenet at 5e-5. Train steps, as
``tests/test_train_parity.py``: losses to rtol 5e-3·(step+1), fc3_1 after
three Adam steps to rtol 5e-2 / atol 5e-4; the default mode also at 1280
points, above the 1024 where the port's auction goes to its stream kernel
on the card (on the CPU both sides run their plain auctions). In the auction modes the port's
step uses the assignments fenet's auction made on fenet's predictions, as
that test does: predictions that differ by ~1e-7 let the auction resolve a
near-tie the other way, and Adam amplifies the changed gradient. Left to its
own auction (measured from this init), the fixed-eps mode kept its losses
within 6.9e-4 but moved fc3_1 1.6e-3 apart; the eps-scaling mode's EMD was
1.8e-5 off at step 1 and its CD 2.2% off at step 3 (ROADMAP Queue 3).
"""

import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
N_POINTS, BATCH, STEPS = 256, 2, 3
# fenet's config fields and flags that the port lacks: its ranks are data
# parallel only (the model fits one card), so it has no tensor parallelism.
FENET_ONLY = {"model_parallel"}
# TrainConfig overrides of the three EMD modes.
EMD_MODES = {
    "auction": dict(emd_iters=300),
    "scaled": dict(emd_iters=300, emd_scale_phases=3, emd_scale_thresh=0.3),
    "sinkhorn": dict(emd_impl="sinkhorn"),
}


def _overrides(mode: str, num_points: int) -> dict:
    """A case's TrainConfig overrides. Above 1024 points the auction runs 50
    iterations: fenet's auction on the CPU takes most of the test's time
    (measured 45 s at 300 iterations and 1280 points, 22 s at 50)."""
    return dict(EMD_MODES[mode], **({"emd_iters": 50} if num_points > 1024 else {}))


def _port_steps(in_path: str, out_path: str) -> None:
    """STEPS train steps of the port's Trainer on the CPU, in the input's
    loss mode ("schedule" unless it names "finetune"); with recorded
    assignments, the auction's plain version returns those."""
    from fenet_torch.models.generator import Generator
    from fenet_torch.ops import emd
    from fenet_torch.ops.pairwise import sqnorm
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer

    blob = np.load(in_path)
    num_points = int(blob["num_points"])
    if "assignments" in blob.files:
        recorded = iter(torch.tensor(a, dtype=torch.int32) for a in blob["assignments"])

        def replay(x1, x2, *args):
            ass = next(recorded)
            return sqnorm(x1 - x2.gather(1, ass.long()[..., None].expand(-1, -1, 3))), ass

        emd._auction_plain = replay
    gen = Generator(num_points=num_points, **SMALL)
    gen.load_state_dict({k[3:]: torch.tensor(blob[k]) for k in blob.files
                         if k.startswith("sd.")}, strict=True)
    cfg = TrainConfig(batch_size=BATCH, num_points=num_points, **SMALL,
                      **_overrides(str(blob["mode"]), num_points))
    loss_mode = str(blob["loss_mode"]) if "loss_mode" in blob.files else "schedule"
    if loss_mode == "finetune":
        cfg.proj_squash = bool(blob["proj_squash"])
    trainer = Trainer(gen, cfg, loss_mode=loss_mode, device="cpu")
    losses = []
    for step in range(STEPS):
        stats = trainer.train_step(blob["imgs"][step], blob["pts"][step], 1, float(blob["lr"]))
        losses.append([float(stats[k]) for k in ("total_loss", "chamfer_loss", "emd_loss")])
    np.savez(out_path, losses=np.asarray(losses), fc3_1=gen.fc3_1.weight.detach().numpy())


if __name__ == "__main__":
    _port_steps(sys.argv[1], sys.argv[2])
    raise SystemExit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from torch import nn  # noqa: E402

from fenet.cli import common as jax_common  # noqa: E402
from fenet.cli import eval_pix3d as jax_eval_pix3d  # noqa: E402
from fenet.cli import finetune as jax_finetune  # noqa: E402
from fenet.models.convert import (  # noqa: E402
    load_torch_checkpoint,
    merge_variables,
    torch_state_dict_to_variables,
)
from fenet.models.generator import Generator as JaxGenerator  # noqa: E402
from fenet.models.generator import init_variables  # noqa: E402
from fenet.ops.emd import earth_mover_distance as jax_emd  # noqa: E402
from fenet.train.config import TrainConfig as JaxTrainConfig  # noqa: E402
from fenet.train.trainer import Trainer as JaxTrainer  # noqa: E402
from fenet.train.trainer import reference_lr_schedule as jax_lr_schedule  # noqa: E402
from fenet.utils.average_meter import AverageMeter as JaxAverageMeter  # noqa: E402
from fenet_torch.cli import common, eval_pix3d, finetune  # noqa: E402
from fenet_torch.data.synthetic import write_synthetic_shapenet  # noqa: E402
from fenet_torch.models.convert import load_reference_checkpoint, state_dict_from_jax  # noqa: E402
from fenet_torch.models.generator import Generator, init_random_  # noqa: E402
from fenet_torch.train import checkpoint  # noqa: E402
from fenet_torch.train.config import TrainConfig  # noqa: E402
from fenet_torch.train.driver import train_net  # noqa: E402
from fenet_torch.train.trainer import Trainer, reference_lr_schedule  # noqa: E402
from fenet_torch.utils.average_meter import AverageMeter  # noqa: E402
from torch_tmp import remove_tmp_path  # noqa: E402,F401  (deletes each test's tmp_path)

OUT_RTOL, OUT_ATOL = 1e-4, 1e-3
VAR_RTOL, MEAN_ATOL = 1e-6, 1e-6
STAGE0_VAR_RTOL = 5e-5  # fenet's own float32 error there, see the docstring


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors in long loops: beside other test workers, torch's OpenMP
    threads oversubscribe the cores and spin (measured 30-50x slower with
    three workers), and one thread is fastest anyway."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _small_models(num_points):
    """fenet's small generator and the port's, from the same weights: the
    port's seeded init (torch's default distributions, as the reference
    trains from), converted into fenet's variables."""
    gen = init_random_(Generator(num_points=num_points, **SMALL),
                       torch.Generator().manual_seed(0))
    state_dict = {k: v.detach().clone() for k, v in gen.state_dict().items()
                  if not k.endswith("num_batches_tracked")}
    model = JaxGenerator(num_points=num_points, **SMALL)
    init = jax.tree_util.tree_map(np.asarray, init_variables(
        model, np.zeros((1, 128, 128, 3), np.float32), rng=jax.random.PRNGKey(0)))
    converted = torch_state_dict_to_variables(state_dict)
    variables = {col: merge_variables(init[col], converted[col])
                 for col in ("params", "batch_stats")}
    return model, variables, state_dict


@pytest.fixture(scope="module")
def small():
    return _small_models(N_POINTS)


def _batch(rng, num_points=N_POINTS):
    imgs = (rng.rand(BATCH, 128, 128, 3) * 255).astype(np.float32)
    pts = (rng.rand(BATCH, num_points, 3) * 0.9).astype(np.float32)
    return imgs, pts


def test_train_mode_forward_and_batch_stats_match_fenet(small):
    model, variables, state_dict = small
    imgs, _ = _batch(np.random.RandomState(0))
    want, mutated = model.apply(variables, jnp.asarray(imgs), train=True,
                                mutable=["batch_stats"])
    want_stats = state_dict_from_jax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, mutated["batch_stats"])})
    gen = Generator(num_points=N_POINTS, **SMALL)
    gen.load_state_dict(state_dict, strict=True)
    stock = Generator(num_points=N_POINTS, **SMALL)
    stock.load_state_dict(state_dict, strict=True)
    inputs = {}
    for name, m in gen.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            m.register_forward_pre_hook(
                lambda _m, x, name=name: inputs.__setitem__(name, x[0].double()))
    for m in stock.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.__class__ = nn.BatchNorm2d  # torch's own update, for contrast
    with torch.no_grad():
        got = gen.train()(torch.tensor(imgs))
        stock.train()(torch.tensor(imgs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=OUT_RTOL, atol=OUT_ATOL)
    ours, theirs = gen.state_dict(), stock.state_dict()
    assert len(want_stats) == 2 * len(inputs)
    stock_gap = 0.0
    for name, x in inputs.items():
        # flax's rule in float64 on the port's own inputs: biased variance,
        # momentum 0.9.
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        rule = {"running_var": 0.9 * state_dict[f"{name}.running_var"].double() + 0.1 * var,
                "running_mean": 0.9 * state_dict[f"{name}.running_mean"].double() + 0.1 * mean}
        for stat, exact in rule.items():
            key = f"{name}.{stat}"
            np.testing.assert_allclose(ours[key].numpy(), exact.numpy(), rtol=VAR_RTOL,
                                       atol=MEAN_ATOL, err_msg=key)
            rtol = STAGE0_VAR_RTOL if name.startswith("RepVGG.stage0.") else VAR_RTOL
            np.testing.assert_allclose(ours[key].numpy(), want_stats[key].numpy(), rtol=rtol,
                                       atol=MEAN_ATOL, err_msg=key)
        key = f"{name}.running_var"
        stock_gap = max(stock_gap, float(((theirs[key] - want_stats[key]) / want_stats[key])
                                         .abs().max()))
    # The stock unbiased update misses by n/(n-1) on the batch variance:
    # 3.2% at the 4x4 map of batch 2, ~0.3% of the running variance.
    assert stock_gap > 1e-3


@pytest.mark.parametrize("mode,num_points", [(m, N_POINTS) for m in EMD_MODES]
                         + [("auction", 1280)],
                         ids=list(EMD_MODES) + ["auction-1280"])
def test_train_steps_match_fenet(mode, num_points, tmp_path):
    model, variables, state_dict = _small_models(num_points)
    cfg = JaxTrainConfig(batch_size=BATCH, num_points=num_points, **SMALL,
                         **_overrides(mode, num_points))
    trainer = JaxTrainer(model, cfg)
    state = trainer.state_from_variables(variables)
    rng = np.random.RandomState(1)
    lr = jax_lr_schedule(cfg.lr, 1)

    @jax.jit
    def assignment(params, batch_stats, img, pt):
        (_, _, pc3), _ = model.apply({"params": params, "batch_stats": batch_stats}, img,
                                     train=True, mutable=["batch_stats"])
        return jax_emd(pc3, pt, cfg.emd_eps, cfg.emd_iters, cfg.emd_scale_phases,
                       cfg.emd_early_exit, cfg.emd_scale_thresh)[1]

    imgs, pts, assignments, want = [], [], [], []
    for _ in range(STEPS):
        img, pt = _batch(rng, num_points)
        imgs.append(img)
        pts.append(pt)
        img, pt = jnp.asarray(img), jnp.asarray(pt)
        assignments.append(np.asarray(assignment(state.params, state.batch_stats, img, pt)))
        state, stats = trainer.train_step(state, img, pt, 1, lr)
        want.append([float(stats[k]) for k in ("total_loss", "chamfer_loss", "emd_loss")])
    recorded = {} if mode == "sinkhorn" else {"assignments": np.stack(assignments)}
    np.savez(tmp_path / "in.npz", mode=mode, num_points=num_points, imgs=np.stack(imgs),
             pts=np.stack(pts), lr=lr,
             **recorded, **{f"sd.{k}": v.numpy() for k, v in state_dict.items()})
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, __file__, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, cwd=REPO, env=env, timeout=600)
    got = np.load(tmp_path / "out.npz")
    for step in range(STEPS):
        np.testing.assert_allclose(got["losses"][step], want[step], rtol=5e-3 * (step + 1),
                                   err_msg=f"{mode}: losses at step {step}")
    np.testing.assert_allclose(
        got["fc3_1"], np.asarray(state.params["decoder"]["fc3_1"]["kernel"]).T,
        rtol=5e-2, atol=5e-4)


def test_train_config_matches_fenet():
    """The same fields with the same defaults, with two deliberate
    differences: the checkpoint container (the port defaults to the
    reference's .pth.tar and writes fenet's flax .ckpt on request), and
    FENET_ONLY, which the port lacks."""
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert ours.keys() == theirs.keys() - FENET_ONLY
    assert {k for k in ours if ours[k] != theirs[k]} == {"ckpt_format"}
    assert ours["ckpt_format"] == "torch"
    for epoch in range(1, 51):
        assert reference_lr_schedule(5e-4, epoch) == jax_lr_schedule(5e-4, epoch)


def test_cli_flags_match_fenet():
    import argparse

    ours = common.add_common_args(argparse.ArgumentParser()).parse_args([])
    theirs = jax_common.add_common_args(argparse.ArgumentParser()).parse_args([])
    assert set(vars(ours)) - set(vars(theirs)) == {"device"}
    assert set(vars(theirs)) - set(vars(ours)) == FENET_ONLY
    mine, ref = common.config_from_args(ours), jax_common.config_from_args(theirs)
    diff = {f.name for f in dataclasses.fields(mine)
            if getattr(mine, f.name) != getattr(ref, f.name)}
    assert diff == {"ckpt_format"}
    # The finetune and eval_pix3d CLIs: fenet's flags and defaults, plus
    # --device (and the checkpoint container's default and FENET_ONLY, as
    # above).
    for ours, theirs, differ, lacks in (
            (finetune.main, jax_finetune.main, {"ckpt_format"}, FENET_ONLY),
            (eval_pix3d.main, jax_eval_pix3d.main, set(), set())):
        ours, theirs = _cli_defaults(ours), _cli_defaults(theirs)
        assert set(ours) - set(theirs) == {"device"} and set(theirs) - set(ours) == lacks
        assert {k for k in theirs.keys() - lacks if ours[k] != theirs[k]} == differ
    assert _cli_defaults(finetune.main)["nepoch"] == 10


class _Parsed(Exception):
    pass


def _cli_defaults(main) -> dict:
    """The namespace ``main([])`` parses, stopping right after parsing."""
    import argparse
    from unittest import mock

    parse = argparse.ArgumentParser.parse_args
    seen = {}

    def capture(parser, args=None, namespace=None):
        seen.update(vars(parse(parser, args, namespace)))
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(_Parsed):
            main([])
    return seen


def test_average_meter_matches_fenet():
    for items in (None, ["a", "b"]):
        ours, theirs = AverageMeter(items), JaxAverageMeter(items)
        for v in ([1.0, 2.0], [3.0, 5.0], [0.5, 0.25]):
            value = v if items else v[0]
            ours.update(value)
            theirs.update(value)
        assert ours.val() == theirs.val() and ours.avg() == theirs.avg()
        assert ours.count() == theirs.count() and ours.avg(0) == theirs.avg(0)


def test_options_of_later_slices_raise(tmp_path, monkeypatch):
    gen = Generator(num_points=N_POINTS, **SMALL)
    with pytest.raises(ValueError, match="loss_mode"):
        Trainer(gen, TrainConfig(), loss_mode="pretrain", device="cpu")
    with pytest.raises(ValueError, match="launch one process per rank"):
        Trainer(gen, TrainConfig(data_parallel=2), device="cpu")  # one process is one rank
    with pytest.raises(ValueError, match="emd_impl"):
        Trainer(gen, TrainConfig(emd_impl="exact"), device="cpu")
    # A container neither fenet nor the port has raises, before anything
    # is written.
    with pytest.raises(ValueError, match="pickle"):
        checkpoint.save_checkpoint({}, False, "c", str(tmp_path), 1, fmt="pickle")
    with pytest.raises(ValueError, match="pickle"):
        train_net("c", TrainConfig(ckpt_format="pickle", dir_path=str(tmp_path)),
                  train_ds=[], val_ds=[], model=gen, device="cpu")
    assert not list(tmp_path.iterdir())
    # fenet's flax and orbax containers are ported
    # (tests/test_torch_checkpoint_{flax,orbax}.py): orbax saves and loads
    # back, and train_net takes it.
    state = {"state_dict": gen.state_dict(), "epoch": 1}
    path = checkpoint.save_checkpoint(state, True, "c", str(tmp_path / "ckpt"), 1, fmt="orbax")
    for name in (path, str(tmp_path / "ckpt" / "model_best.orbax")):
        blob = checkpoint.load_checkpoint(name)
        assert blob["epoch"] == 1 and "optimizer" not in blob
        for key, value in blob["state_dict"].items():
            assert torch.equal(value, gen.state_dict()[key]), key
    out = train_net("c", TrainConfig(ckpt_format="orbax", nepoch=0, dir_path=str(tmp_path)),
                    train_ds=[], val_ds=[], model=gen, device="cpu")
    assert out["history"] == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(gen, TrainConfig())


def test_train_net_cli_checkpoints_and_resume(tmp_path):
    """Two epochs through the CLI on a synthetic tree: validation at epoch 2
    writes model_best.pth.tar, which loads with strict=True (and into
    fenet); --resume then continues at epoch 3 from it."""
    cat = "02828884"
    write_synthetic_shapenet(str(tmp_path), cats=(cat,), models_per_cat=1,
                             num_points=N_POINTS)
    args = [sys.executable, "-m", "fenet_torch.cli.train", "--device", "cpu", "--cats", cat,
            "--batchSize", "24", "--num_points", str(N_POINTS), "--backbone", "RepVGG-TEST",
            "--fine_width", "32", "--mid_width", "16", "--emd_iters", "50",
            "--validate_epochs", "2", "--train_save_freq", "3",
            "--dir_path", str(tmp_path / "out"), "--splits_path", str(tmp_path / "splits"),
            "--data_dir_imgs", str(tmp_path / "ShapeNetRendering"),
            "--data_dir_pcl", str(tmp_path / "ShapeNet_pointclouds")]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    subprocess.run(args + ["--nepoch", "2"], check=True, cwd=REPO, env=env, timeout=600,
                   capture_output=True)
    ckpt_dir = tmp_path / "out" / cat / "checkpoints"
    best = ckpt_dir / checkpoint.BEST
    blob = checkpoint.load_checkpoint(str(best))
    assert set(blob) == {"state_dict", "optimizer", "epoch", "train_time",
                         "best_chamfer_loss", "best_emd_loss", "model_name"}
    assert blob["epoch"] == 2 and np.isfinite(blob["best_emd_loss"])
    assert checkpoint.latest_checkpoint(str(ckpt_dir), cat) == str(
        ckpt_dir / f"{cat}_checkpoint_2.pth.tar")
    gen = Generator(num_points=N_POINTS, **SMALL)
    gen.load_state_dict(blob["state_dict"], strict=True)
    load_reference_checkpoint(Generator(num_points=N_POINTS, **SMALL), str(best))
    assert "fc1_1" in load_torch_checkpoint(str(best))["params"]["decoder"]

    subprocess.run(args + ["--nepoch", "3", "--resume", "True"], check=True, cwd=REPO,
                   env=env, timeout=600, capture_output=True)
    resumed = checkpoint.load_checkpoint(str(ckpt_dir / f"{cat}_checkpoint_3.pth.tar"))
    assert resumed["epoch"] == 3 and resumed["train_time"] > blob["train_time"]
    assert resumed["best_emd_loss"] == blob["best_emd_loss"]
    log = (ckpt_dir / "logging.log").read_text()
    assert log.count("[Epoch 1/") == log.count("[Epoch 2/") == 1  # first run only
    assert log.count("[Epoch 3/3]") == 1
