"""The fenet_torch eval slice against fenet's: ICP, metrics, the eval step,
evaluate_dataset, the data layer and the eval CLI, on the same inputs and
weights, forward only, in one process (data crosses as numpy arrays).

Tolerances: the generator's float32 outputs differ from fenet's by ~5e-7
(convolution summation order). ICP and chamfer carry that through. The
50-iteration eval auction does not: a difference of 1e-7 in an input can
flip a near-tied bid, and from there the auction takes another path; the
per-sample EMD metric then moved by up to 2.3% on these untrained
predictions. So the full step holds EMD to 5%, and EMD on identical inputs
is held exactly.
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

from fenet.data.loader import DataLoader as JaxDataLoader
from fenet.data.shapenet import ShapeNetDataset as JaxShapeNetDataset
from fenet.data.synthetic import SyntheticShapeNet as JaxSyntheticShapeNet
from fenet.eval.metrics import eval_metrics as jax_eval_metrics
from fenet.eval.runner import evaluate_dataset as jax_evaluate_dataset
from fenet.eval.runner import make_eval_step as jax_make_eval_step
from fenet.geometry.icp import _quat_to_rotmat as jax_quat_to_rotmat
from fenet.geometry.icp import align_pred_to_gt as jax_align_pred_to_gt
from fenet.geometry.icp import batched_icp as jax_batched_icp
from fenet.geometry.icp import best_fit_rotation_batched as jax_best_fit_rotation
from fenet.models.generator import Generator as JaxGenerator
from fenet.models.generator import init_variables
from fenet.ops.emd import earth_mover_distance as jax_emd
from fenet.parallel.mesh import make_mesh
from fenet.train.checkpoint import export_torch_checkpoint
from fenet_torch.cli import eval_pix3d, eval_shapenet
from fenet_torch.data.loader import DataLoader
from fenet_torch.data.shapenet import NUM_VIEWS, ShapeNetDataset, load_split
from fenet_torch.data.synthetic import SyntheticShapeNet, write_synthetic_shapenet
from fenet_torch.eval.metrics import Metrics, eval_metrics
from fenet_torch.eval.runner import evaluate_dataset, make_eval_step
from fenet_torch.geometry import icp
from fenet_torch.models.convert import state_dict_from_jax
from fenet_torch.models.generator import Generator
from fenet_torch.ops.emd import earth_mover_distance
from fenet_torch.train.config import TrainConfig
from fenet_torch.train.trainer import Trainer
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
CD_RTOL = 1e-5  # chamfer through generator + ICP, float32
PRED_ATOL = 1e-5  # aligned clouds of unit scale
EMD_RTOL = 5e-2  # auction path divergence, see the module docstring


def _small_variables(num_points):
    """fenet variables for the small generator, output heads scaled by 1e-3
    so the untrained prediction is a unit-scale cloud, as a trained model's
    is (at raw scale it is ~400 across and ICP onto a 0.4 gt is ill-posed)."""
    model = JaxGenerator(num_points=num_points, **SMALL)
    v = init_variables(model, np.zeros((1, 128, 128, 3), np.float32))
    v = jax.tree_util.tree_map(np.asarray, v)
    for name in ("fc3_1", "conv2_1", "conv1_3"):
        for leaf in ("kernel", "bias"):
            v["params"]["decoder"][name][leaf] = (
                v["params"]["decoder"][name][leaf] * np.float32(1e-3))
    return model, v


def _port_model(variables, num_points):
    gen = Generator(num_points=num_points, **SMALL)
    gen.load_state_dict(state_dict_from_jax(variables), strict=True)
    return gen


@pytest.fixture(scope="module")
def small():
    model, variables = _small_variables(1024)
    return model, variables, _port_model(variables, 1024)


class _Take:
    """The given indices of a dataset."""

    def __init__(self, ds, indices):
        self.ds, self.indices = ds, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.ds[self.indices[i]]


def _rigid_pair(seed, n=256):
    rng = np.random.RandomState(seed)
    b = rng.rand(2, n, 3).astype(np.float32)
    ang = 0.3
    r = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1]], np.float32)
    a = b @ r.T + np.array([0.05, -0.02, 0.03], np.float32)
    return (a + rng.normal(0, 0.01, b.shape)).astype(np.float32), b


@pytest.mark.parametrize("coarse_points", [0, 64])
def test_batched_icp_matches_fenet(coarse_points):
    a, b = _rigid_pair(0)
    want = jax_batched_icp(jnp.asarray(a), jnp.asarray(b),
                               coarse_points=coarse_points)
    got = icp.batched_icp(torch.tensor(a), torch.tensor(b), coarse_points=coarse_points)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_align_pred_to_gt_matches_fenet():
    pred, gt = _rigid_pair(1)
    want = jax_align_pred_to_gt(jnp.asarray(pred), jnp.asarray(gt))
    got = icp.align_pred_to_gt(torch.tensor(pred), torch.tensor(gt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), gt, atol=0.05)  # noise 0.01 per axis


def test_rotation_pieces_match_fenet():
    rng = np.random.RandomState(2)
    q = rng.randn(5, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(icp._quat_to_rotmat(torch.tensor(q)).numpy(),
                               np.asarray(jax_quat_to_rotmat(jnp.asarray(q))),
                               rtol=0, atol=1e-6)
    a, b = _rigid_pair(3)
    r_j, t_j = jax_best_fit_rotation(jnp.asarray(a), jnp.asarray(b))
    r_t, t_t = icp.best_fit_rotation_batched(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0, atol=1e-5)


def test_eval_metrics_match_fenet():
    # Dyadic coordinates k/64: fenet's eval_metrics is one jitted program
    # whose fusion may round the cross term unlike eager code; on dyadic
    # inputs it is exact, the auction takes the same path, and only the
    # float32 order of the final means may differ.
    rng = np.random.RandomState(4)
    pred, gt = (rng.randint(0, 65, (2, 3, 256, 3)) / 64.0).astype(np.float32)
    want = jax_eval_metrics(jnp.asarray(pred), jnp.asarray(gt))
    got = eval_metrics(torch.tensor(pred), torch.tensor(gt))
    for name in Metrics.names():
        np.testing.assert_allclose(float(got[name]), float(want[name]), rtol=1e-6)
    assert Metrics.get(torch.tensor(pred), torch.tensor(gt)) == [
        float(got[n]) for n in Metrics.names()]


def test_metrics_value_object():
    a = Metrics("ChamferDistance", [1.0, 2.0])
    b = Metrics("ChamferDistance", {"ChamferDistance": 3.0})
    assert a.state_dict() == {"EMD_distance": 1.0, "ChamferDistance": 2.0}
    assert b.state_dict() == {"EMD_distance": 32767, "ChamferDistance": 3.0}
    assert a.better_than(b) and not b.better_than(a) and a.better_than(None)
    with pytest.raises(TypeError):
        Metrics("EMD_distance", 1.0)


def test_eval_step_matches_fenet(small):
    model, variables, gen = small
    ds = SyntheticShapeNet(n_models=2, seed=0)
    images = np.stack([ds[0]["image"], ds[NUM_VIEWS]["image"]]).astype(np.uint8)
    points = np.stack([ds[0]["points"], ds[NUM_VIEWS]["points"]])
    # conftest forces 8 CPU devices; a one-device mesh takes a batch of 2.
    step, _ = jax_make_eval_step(model, mesh=make_mesh(1))
    want = {k: np.asarray(v) for k, v in step(variables, images, points).items()}
    got = make_eval_step(gen, device="cpu")(images, points)
    assert tuple(got["pred"].shape) == (2, 1024, 3)
    np.testing.assert_allclose(got["pred"].numpy(), want["pred"], rtol=0, atol=PRED_ATOL)
    np.testing.assert_allclose(got["cd"].numpy(), want["cd"], rtol=CD_RTOL)
    np.testing.assert_allclose(got["emd"].numpy(), want["emd"], rtol=EMD_RTOL)
    # On fenet's own aligned clouds the port's EMD is fenet's, exactly.
    emd_sq, _ = jax_emd(jnp.asarray(want["pred"]), jnp.asarray(points), 0.005, 50)
    ours, _ = earth_mover_distance(torch.tensor(want["pred"]), torch.tensor(points))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(emd_sq))


@pytest.mark.parametrize("num_points", [1024, 1280])
def test_evaluate_dataset_matches_fenet(small, num_points):
    """Also at 1280 points, above the 1024 where the port's auction goes to
    its stream kernel on the card (on the CPU both sides run their plain
    auctions)."""
    if num_points == 1024:
        model, variables, gen = small
    else:
        model, variables = _small_variables(num_points)
        gen = _port_model(variables, num_points)
    indices = [0, NUM_VIEWS, 1, NUM_VIEWS + 1]
    port_ds = _Take(SyntheticShapeNet(n_models=2, num_points=num_points, seed=1), indices)
    jax_ds = _Take(JaxSyntheticShapeNet(n_models=2, num_points=num_points, seed=1), indices)
    _, _, want = jax_evaluate_dataset(model, variables, JaxDataLoader(jax_ds, 2),
                                      mesh=make_mesh(1))
    cd_m, emd_m, got = evaluate_dataset(gen, DataLoader(port_ds, 2), device="cpu")
    assert got["samples"] == want["samples"] == 4
    np.testing.assert_allclose(got["ChamferDistance"], want["ChamferDistance"], rtol=CD_RTOL)
    np.testing.assert_allclose(got["EMD_distance"], want["EMD_distance"], rtol=EMD_RTOL)
    assert cd_m.metric_name == "ChamferDistance" and emd_m.metric_name == "EMD_distance"
    assert cd_m.state_dict() == {"EMD_distance": got["EMD_distance"],
                                 "ChamferDistance": got["ChamferDistance"]}


def test_synthetic_data_matches_fenet():
    ours, ref = SyntheticShapeNet(n_models=2, seed=5, multi_resolution=True,
                                  variety=True), JaxSyntheticShapeNet(
        n_models=2, seed=5, multi_resolution=True, variety=True)
    assert len(ours) == len(ref)
    for i in (0, 7, 30):
        a, b = ours[i], ref[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shuffle,drop_last,prefetch", [(True, False, 2), (False, True, 0)])
def test_dataloader_matches_fenet(shuffle, drop_last, prefetch):
    ds = SyntheticShapeNet(n_models=1, seed=0)
    kw = dict(shuffle=shuffle, drop_last=drop_last, prefetch=prefetch, seed=3)
    ours, ref = list(DataLoader(ds, 5, **kw)), list(JaxDataLoader(ds, 5, **kw))
    assert len(ours) == len(ref) == len(DataLoader(ds, 5, **kw))
    for a, b in zip(ours, ref):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_eval_cli_on_synthetic_tree(tmp_path):
    """The CLI reads the reference layout and a .pth.tar exported by fenet,
    and gives what evaluate_dataset gives with the same weights."""
    n = 256
    cat = "02691156"
    write_synthetic_shapenet(str(tmp_path), cats=(cat,), models_per_cat=1, num_points=n)
    imgs, pcl = tmp_path / "ShapeNetRendering", tmp_path / "ShapeNet_pointclouds"
    _, variables = _small_variables(n)
    ckpt = tmp_path / "out" / cat / "checkpoints"
    ckpt.mkdir(parents=True)
    export_torch_checkpoint(variables, str(ckpt / "model_best.pth.tar"))

    results = eval_shapenet.main([
        "--device", "cpu", "--batchSize", "8", "--num_points", str(n),
        "--backbone", SMALL["backbone"], "--fine_width", "32", "--mid_width", "16",
        "--cats", cat, "--model", str(tmp_path / "out" / "%s" / "checkpoints"),
        "--splits_path", str(tmp_path / "splits"),
        "--data_dir_imgs", str(imgs), "--data_dir_pcl", str(pcl),
    ])
    summary = results[cat]
    assert summary["samples"] == NUM_VIEWS
    ds = ShapeNetDataset(str(imgs), str(pcl), load_split(str(tmp_path / "splits"),
                         "val_models.json"), [cat], n, check_exists=True,
                         image_dtype="uint8")
    _, _, direct = evaluate_dataset(_port_model(variables, n), DataLoader(ds, 8),
                                    device="cpu")
    for key in ("EMD_distance", "ChamferDistance", "samples"):
        assert summary[key] == direct[key]
    assert np.isfinite(summary["EMD_distance"]) and np.isfinite(summary["ChamferDistance"])
    # The port's reader returns what fenet's returns, byte for byte.
    ref = JaxShapeNetDataset(str(imgs), str(pcl), load_split(str(tmp_path / "splits"),
                             "val_models.json"), [cat], n, check_exists=True,
                             image_dtype="uint8", variety=True)
    ds.variety = True
    for i in (0, 13):
        for k, v in ref[i].items():
            np.testing.assert_array_equal(ds[i][k], v)
    with pytest.raises(SystemExit):
        eval_shapenet.main(["--deploy", "--device", "cpu"])


def test_port_imports_no_jax():
    """Importing every fenet_torch module pulls in no jax, flax or fenet."""
    code = (
        "import importlib, pkgutil, sys, fenet_torch\n"
        "for m in pkgutil.walk_packages(fenet_torch.__path__, 'fenet_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'flax', 'fenet'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('fenet_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    """The eval step, the finetune trainer and the eval_pix3d entry run on
    the card unless asked for the CPU; eval_pix3d raises before it reads
    anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = Generator(num_points=256, **SMALL)
    with pytest.raises(RuntimeError, match="cuda"):
        make_eval_step(gen)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(gen, TrainConfig(), loss_mode="finetune")
    with pytest.raises(RuntimeError, match="cuda"):
        eval_pix3d.main(["--data_dir", str(tmp_path / "absent"),
                         "--model", str(tmp_path / "absent" / "%s")])
