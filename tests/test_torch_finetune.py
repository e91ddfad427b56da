"""The fenet_torch finetune path against fenet's: three steps of
``Trainer(loss_mode="finetune")``, the finetune CLI resuming from a
``train_net`` checkpoint, and the epochs a resumed finetune runs.

The port's steps run in a subprocess (torch autograd and XLA:CPU corrupt
the heap in one process): ``tests/test_torch_train.py`` run as a script,
in the input's loss mode. As in ``test_train_steps_match_fenet``, the port
replays the assignments fenet's auction made on fenet's predictions, and
the losses are held to rtol 5e-3·(step+1), ``fc3_1`` after three Adam steps
to rtol 5e-2 / atol 5e-4.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenet.data.synthetic import SyntheticShapeNet as JaxSyntheticShapeNet
from fenet.ops.emd import earth_mover_distance as jax_emd
from fenet.train import driver as jax_driver
from fenet.train.checkpoint import save_checkpoint as jax_save_checkpoint
from fenet.train.config import TrainConfig as JaxTrainConfig
from fenet.train.trainer import Trainer as JaxTrainer
from fenet.train.trainer import reference_lr_schedule as jax_lr_schedule
from fenet_torch.data.synthetic import SyntheticShapeNet, write_synthetic_shapenet
from fenet_torch.models.generator import Generator
from fenet_torch.train import checkpoint, driver
from fenet_torch.train.config import TrainConfig
from fenet_torch.train.trainer import Trainer, make_optimizer, reference_lr_schedule
from test_torch_train import BATCH, N_POINTS, SMALL, STEPS, _batch, _small_models
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "tests" / "test_torch_train.py"
FINETUNE_LR = 5e-5  # the finetune CLI's
CAT = "02828884"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("squash", [False, True], ids=["raw", "squash"])
def test_finetune_steps_match_fenet(squash, tmp_path):
    """Three finetune steps (100·BCE + 100·CD + 100·EMD, the auction at
    0.05 / 300) from the same weights, with the raw and the squashed
    silhouettes."""
    model, variables, state_dict = _small_models(N_POINTS)
    cfg = JaxTrainConfig(batch_size=BATCH, num_points=N_POINTS, emd_iters=300,
                         proj_squash=squash, **SMALL)
    trainer = JaxTrainer(model, cfg, loss_mode="finetune")
    state = trainer.state_from_variables(variables)
    rng = np.random.RandomState(2)
    lr = jax_lr_schedule(FINETUNE_LR, 1)

    @jax.jit
    def assignment(params, batch_stats, img, pt):
        (_, _, pc3), _ = model.apply({"params": params, "batch_stats": batch_stats}, img,
                                     train=True, mutable=["batch_stats"])
        return jax_emd(pc3, pt, cfg.emd_eps, cfg.emd_iters)[1]

    imgs, pts, assignments, want = [], [], [], []
    for _ in range(STEPS):
        img, pt = _batch(rng)
        imgs.append(img)
        pts.append(pt)
        img, pt = jnp.asarray(img), jnp.asarray(pt)
        assignments.append(np.asarray(assignment(state.params, state.batch_stats, img, pt)))
        state, stats = trainer.train_step(state, img, pt, 1, lr)
        want.append([float(stats[k]) for k in ("total_loss", "chamfer_loss", "emd_loss")])
    np.savez(tmp_path / "in.npz", mode="auction", loss_mode="finetune", proj_squash=squash,
             num_points=N_POINTS, imgs=np.stack(imgs), pts=np.stack(pts), lr=lr,
             assignments=np.stack(assignments),
             **{f"sd.{k}": v.numpy() for k, v in state_dict.items()})
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, str(SCRIPT), str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, cwd=REPO, env=env, timeout=600)
    got = np.load(tmp_path / "out.npz")
    for step in range(STEPS):
        np.testing.assert_allclose(got["losses"][step], want[step], rtol=5e-3 * (step + 1),
                                   err_msg=f"losses at step {step}")
        # The BCE term is in the total: total - 100·(CD + EMD) is 100·BCE.
        assert not np.isclose(want[step][0], 100 * (want[step][1] + want[step][2]))
    np.testing.assert_allclose(
        got["fc3_1"], np.asarray(state.params["decoder"]["fc3_1"]["kernel"]).T,
        rtol=5e-2, atol=5e-4)


def test_finetune_cli_resumes_from_train_net(tmp_path):
    """train_net through the train CLI writes model_best at epoch 1; the
    finetune CLI resumes from it and, with --nepoch 2 past the checkpoint's
    epoch, finetunes epoch 2 and validates it."""
    write_synthetic_shapenet(str(tmp_path), cats=(CAT,), models_per_cat=1,
                             num_points=N_POINTS)
    common = ["--device", "cpu", "--cats", CAT, "--batchSize", "24",
              "--num_points", str(N_POINTS), "--backbone", "RepVGG-TEST",
              "--fine_width", "32", "--mid_width", "16", "--emd_iters", "50",
              "--dir_path", str(tmp_path / "out"), "--splits_path", str(tmp_path / "splits"),
              "--data_dir_imgs", str(tmp_path / "ShapeNetRendering"),
              "--data_dir_pcl", str(tmp_path / "ShapeNet_pointclouds"),
              "--train_save_freq", "0"]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for cli, extra in (("train", ["--nepoch", "1", "--validate_epochs", "1"]),
                       ("finetune", ["--nepoch", "2", "--validate_epochs", "2",
                                     "--grid_h", "32", "--grid_w", "32"])):
        subprocess.run([sys.executable, "-m", f"fenet_torch.cli.{cli}", *common, *extra],
                       check=True, cwd=REPO, env=env, timeout=600, capture_output=True)
    ckpt_dir = tmp_path / "out" / CAT / "checkpoints"
    first = checkpoint.load_checkpoint(str(ckpt_dir / f"{CAT}_checkpoint_1.pth.tar"))
    tuned = checkpoint.load_checkpoint(str(ckpt_dir / f"{CAT}_checkpoint_2.pth.tar"))
    assert first["epoch"] == 1 and tuned["epoch"] == 2
    assert tuned["train_time"] > first["train_time"]
    assert np.isfinite(tuned["best_emd_loss"])
    assert not torch.equal(tuned["state_dict"]["fc3_1.weight"],
                           first["state_dict"]["fc3_1.weight"])
    # Adam's state went on from the checkpoint's: two steps in all.
    assert int(tuned["optimizer"]["state"][0]["step"]) == 2
    Generator(num_points=N_POINTS, **SMALL).load_state_dict(tuned["state_dict"], strict=True)
    log = (ckpt_dir / "logging.log").read_text()
    assert log.count("[Epoch 1/1]") and log.count("[Epoch 2/2]")


@pytest.mark.parametrize("nepoch,epochs", [(10, []), (50, []), (52, [51, 52])],
                         ids=["default", "at_checkpoint", "past_checkpoint"])
def test_resumed_finetune_runs_fenets_epochs(nepoch, epochs, tmp_path, monkeypatch):
    """Both packages resume a finetune from a model_best of epoch 50 and
    run epochs checkpoint + 1 .. --nepoch: none at the CLI's default 10 or at
    50, and 51-52 at 52, at the decayed LR of reference_lr_schedule. The
    steps themselves are replaced by a recorder."""
    runs = {"fenet": [], "port": []}

    def jax_fit_epoch(self, state, dataloader, epoch, **kwargs):
        runs["fenet"].append((epoch, jax_lr_schedule(self.config.lr, epoch), self.loss_mode))
        return state, {"chamfer_loss": 0.0, "emd_loss": 0.0}

    def port_fit_epoch(self, dataloader, epoch, **kwargs):
        runs["port"].append((epoch, reference_lr_schedule(self.config.lr, epoch),
                             self.loss_mode))
        return {"chamfer_loss": 0.0, "emd_loss": 0.0}

    monkeypatch.setattr(JaxTrainer, "fit_epoch", jax_fit_epoch)
    monkeypatch.setattr(Trainer, "fit_epoch", port_fit_epoch)
    kw = dict(batch_size=BATCH, num_points=N_POINTS, nepoch=nepoch, lr=FINETUNE_LR,
              resume=True, validate_epochs=(), train_save_freq=0, manual_seed=1, **SMALL)

    # fenet: a model_best.ckpt of epoch 50 from its own initial state.
    jax_cfg = JaxTrainConfig(dir_path=str(tmp_path / "fenet"), **kw)
    model, variables, state_dict = _small_models(N_POINTS)
    state = JaxTrainer(model, jax_cfg, loss_mode="finetune").state_from_variables(variables)
    jax_save_checkpoint({"params": state.params, "batch_stats": state.batch_stats,
                         "opt_state": state.opt_state, "epoch": 50},
                        True, CAT, str(tmp_path / "fenet" / CAT / "checkpoints"), 50)
    jax_ds = JaxSyntheticShapeNet(n_models=1, num_points=N_POINTS)
    out = jax_driver.train_net(CAT, jax_cfg, jax_ds, jax_ds, loss_mode="finetune",
                               model=model)

    # The port: a model_best.pth.tar of epoch 50 with its optimizer state.
    cfg = TrainConfig(dir_path=str(tmp_path / "port"), **kw)
    gen = Generator(num_points=N_POINTS, **SMALL)
    gen.load_state_dict(state_dict, strict=True)
    checkpoint.save_checkpoint(
        {"state_dict": gen.state_dict(), "optimizer": make_optimizer(gen, cfg).state_dict(),
         "epoch": 50}, True, CAT, str(tmp_path / "port" / CAT / "checkpoints"), 50)
    ds = SyntheticShapeNet(n_models=1, num_points=N_POINTS)
    ours = driver.train_net(CAT, cfg, ds, ds, loss_mode="finetune", model=gen, device="cpu")

    assert [e for e, _, _ in runs["port"]] == [e for e, _, _ in runs["fenet"]] == epochs
    assert runs["port"] == runs["fenet"]
    assert all(mode == "finetune" and lr < FINETUNE_LR for _, lr, mode in runs["port"])
    assert [h["epoch"] for h in ours["history"]] == [h["epoch"] for h in out["history"]]
