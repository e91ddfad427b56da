"""The fenet_torch Pix3D evaluation against fenet's: the synthetic tree
writer, ``Pix3DDataset`` and the ``eval_pix3d`` CLI, on the same files and
weights (forward only, one process).

The writer and the dataset are held byte for byte. The CLI's summary is
held as ``test_evaluate_dataset_matches_fenet`` holds evaluate_dataset's:
CD to rtol 1e-5 and EMD to 5%, because the 50-iteration auction turns the
generators' ~5e-7 difference into another path (ROADMAP Queue 3).
"""

import os
import shutil

import cv2
import jax
import numpy as np
import pytest

from fenet.cli import eval_pix3d as jax_eval_pix3d
from fenet.data.pix3d import Pix3DDataset as JaxPix3DDataset
from fenet.data.synthetic import write_synthetic_pix3d as jax_write_synthetic_pix3d
from fenet.models.generator import Generator as JaxGenerator
from fenet.models.generator import init_variables
from fenet.train.checkpoint import export_torch_checkpoint, save_checkpoint
from fenet_torch.cli import eval_pix3d
from fenet_torch.data.pix3d import HEIGHT, WIDTH, Pix3DDataset
from fenet_torch.data.synthetic import write_synthetic_pix3d
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

SMALL = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
N_POINTS = 256
CATS = ("chair", "sofa", "table")
CD_RTOL, EMD_RTOL = 1e-5, 5e-2


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A synthetic tree with 3 samples a category; one mask is rewritten
    the way real Pix3D masks load (0/255, so image * mask wraps) and one at
    another size than its image (the resize branch)."""
    root = str(tmp_path_factory.mktemp("pix3d"))
    entries = write_synthetic_pix3d(root, cats=CATS, samples_per_cat=3, num_points=N_POINTS,
                                    seed=4)
    chair = [e for e in entries if e["category"] == "chair"]
    mask = cv2.imread(os.path.join(root, chair[0]["mask"]))
    cv2.imwrite(os.path.join(root, chair[0]["mask"]), mask * 255)
    mask = cv2.imread(os.path.join(root, chair[1]["mask"]))
    cv2.imwrite(os.path.join(root, chair[1]["mask"]), cv2.resize(mask, (97, 131)))
    yield root, entries
    shutil.rmtree(root, ignore_errors=True)


def test_write_synthetic_pix3d_matches_fenet(tmp_path):
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    for write, root in ((write_synthetic_pix3d, ours), (jax_write_synthetic_pix3d, theirs)):
        entries = write(str(root), cats=("chair", "sofa"), samples_per_cat=2, num_points=128,
                        seed=3)
        assert len(entries) == 4
    names = _files(ours)
    assert names == _files(theirs) and len(names) == 4 * 3 + 1
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name


def test_pix3d_dataset_matches_fenet(tree):
    root, entries = tree
    for cat in CATS + ("bed",):
        ours = Pix3DDataset(root, category=cat, num_points=N_POINTS, save=True)
        theirs = JaxPix3DDataset(root, category=cat, num_points=N_POINTS, save=True)
        assert len(ours) == len(theirs) == (0 if cat == "bed" else 3)
        assert ours.pclpaths == theirs.pclpaths and ours.bbox == theirs.bbox
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert set(a) == set(b) == {"image", "points", "name"}
            assert a["image"].shape == (HEIGHT, WIDTH, 3) and a["image"].dtype == np.float32
            assert a["name"] == b["name"]
            for key in ("image", "points"):
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes(), (cat, i, key)
    # An entry whose cloud is missing is dropped.
    models = [dict(entries[0], model="model/chair/absent/model.obj")] + entries[1:3]
    assert len(Pix3DDataset(root, models, category="chair", num_points=N_POINTS)) == 2


def test_eval_pix3d_matches_fenet(tree, tmp_path):
    """Both CLIs on the tree with one generator's weights under the three
    mapped ShapeNet ids: fenet's model_best.ckpt and the port's
    model_best.pth.tar (the output heads scaled by 1e-3, so the untrained
    prediction is a unit-scale cloud, as a trained model's is)."""
    root, _ = tree
    model = JaxGenerator(num_points=N_POINTS, **SMALL)
    v = jax.tree_util.tree_map(np.asarray, init_variables(
        model, np.zeros((1, 128, 128, 3), np.float32)))
    for name in ("fc3_1", "conv2_1", "conv1_3"):
        for leaf in ("kernel", "bias"):
            v["params"]["decoder"][name][leaf] = (
                v["params"]["decoder"][name][leaf] * np.float32(1e-3))
    for cat in CATS:
        ckpt = tmp_path / "out" / jax_eval_pix3d.PIX3D_TO_SHAPENET[cat] / "checkpoints"
        save_checkpoint({"params": v["params"], "batch_stats": v["batch_stats"], "epoch": 1},
                        True, cat, str(ckpt), 1)
        export_torch_checkpoint(v, str(ckpt / "model_best.pth.tar"))
    assert eval_pix3d.PIX3D_TO_SHAPENET == jax_eval_pix3d.PIX3D_TO_SHAPENET
    args = ["--batchSize", "2", "--num_points", str(N_POINTS), "--backbone", "RepVGG-TEST",
            "--fine_width", "32", "--mid_width", "16", "--cats", "chair", "table",
            "--data_dir", root, "--model", str(tmp_path / "out" / "%s" / "checkpoints")]
    want = jax_eval_pix3d.main(args)
    got = eval_pix3d.main(args + ["--device", "cpu"])
    assert set(got) == set(want) == {"chair", "table"}
    for cat in got:
        assert got[cat]["samples"] == want[cat]["samples"] == 3
        np.testing.assert_allclose(got[cat]["ChamferDistance"], want[cat]["ChamferDistance"],
                                   rtol=CD_RTOL)
        np.testing.assert_allclose(got[cat]["EMD_distance"], want[cat]["EMD_distance"],
                                   rtol=EMD_RTOL)
        assert (tmp_path / "out" / eval_pix3d.PIX3D_TO_SHAPENET[cat] / "checkpoints"
                / "logging_pix3d.log").exists()
    with pytest.raises(SystemExit):
        eval_pix3d.main(["--deploy", "--device", "cpu"])
