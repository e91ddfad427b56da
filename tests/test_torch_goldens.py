"""The F-score and the golden-table recorder of fenet_torch against fenet's:
``losses.fscore`` on the same clouds, and ``cli/record_goldens`` beside
fenet's CLI on one synthetic tree and one ``.pth.tar``, forward only, in
one process; the recorder under two processes in processes of their own.

Tolerances: the F-score rtol 1e-6 (its fractions count the same points);
the golden table's CD rtol 1e-4 and EMD 5e-2, the whole eval step's
(``tests/test_torch_eval.py``: the generator's outputs are ~5e-7 apart and
the 50-iteration auction can resolve a near-tie the other way).
"""

import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenet.cli.record_goldens import main as jax_record_goldens
from fenet.losses.fscore import fscore as jax_fscore
from fenet.models.generator import Generator as JaxGenerator
from fenet.models.generator import init_variables
from fenet.train.checkpoint import export_torch_checkpoint
from fenet_torch.cli import record_goldens
from fenet_torch.data.synthetic import write_synthetic_shapenet
from fenet_torch.losses.fscore import fscore
from torch_ranks import env, free_port, run
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

SMALL = ["--backbone", "RepVGG-TEST", "--fine_width", "32", "--mid_width", "16"]
N_POINTS = 256
FSCORE_RTOL = 1e-6
CD_RTOL, EMD_RTOL = 1e-4, 5e-2
# Three categories with data and checkpoints, one whose data is gone (no
# samples in its split) and one without a checkpoint.
CATS = ("02691156", "02828884", "02933112", "02958343", "03001627")
NO_DATA, NO_CKPT = "02958343", "03001627"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the F-score ----------------------------------------------------------------

def _fscore_case(case):
    rng = np.random.RandomState(0)
    x = rng.rand(3, 128, 3).astype(np.float32)
    if case == "random":  # some points within the threshold, some not
        y = (x + rng.normal(0, 0.01, x.shape)).astype(np.float32)
    elif case == "mixed":  # element 1 has no point within it: 0/0 counts as 0
        y = (x + rng.normal(0, 0.01, x.shape)).astype(np.float32)
        y[1] += 5.0
    else:  # no element has a point within it
        y = x + np.float32(5.0)
    return x, y[:, :96]


@pytest.mark.parametrize("case", ["random", "mixed", "far"])
@pytest.mark.parametrize("threshold", [1e-4, 1e-3])
def test_fscore_matches_fenet(case, threshold):
    x, y = _fscore_case(case)
    want = [float(v) for v in jax_fscore(jnp.asarray(x), jnp.asarray(y), threshold)]
    got = [float(v) for v in fscore(torch.tensor(x), torch.tensor(y), threshold)]
    np.testing.assert_allclose(got, want, rtol=FSCORE_RTOL)
    assert all(np.isfinite(got))
    if case == "far":
        assert got == [0.0, 0.0, 0.0]


# -- record_goldens -------------------------------------------------------------

@pytest.fixture(scope="module")
def goldens_tree(tmp_path_factory):
    """A synthetic tree of CATS (1 model, 24 views each; NO_DATA's files
    removed) and one .pth.tar of fenet's small generator, its output heads
    scaled by 1e-3 so that the untrained prediction is a unit-scale cloud, as
    a trained model's is: at ``ckpt/{cat}/model.pth.tar`` for every category
    but NO_CKPT, and as the port's ``out/{cat}/checkpoints/model_best.pth.tar``
    for the same ones."""
    root = tmp_path_factory.mktemp("goldens")
    write_synthetic_shapenet(str(root), cats=CATS, models_per_cat=1, num_points=N_POINTS)
    for sub in ("ShapeNetRendering", "ShapeNet_pointclouds"):
        shutil.rmtree(root / sub / NO_DATA)
    model = JaxGenerator(num_points=N_POINTS, backbone="RepVGG-TEST", fine_width=32,
                         mid_width=16)
    v = init_variables(model, np.zeros((1, 128, 128, 3), np.float32))
    v = {k: {m: dict(t) for m, t in v[k].items()} for k in v}
    for name in ("fc3_1", "conv2_1", "conv1_3"):
        layer = dict(v["params"]["decoder"][name])
        for leaf in ("kernel", "bias"):
            layer[leaf] = np.asarray(layer[leaf]) * np.float32(1e-3)
        v["params"]["decoder"][name] = layer
    first = None
    for cat in CATS:
        if cat == NO_CKPT:
            continue
        for path in (root / "ckpt" / cat / "model.pth.tar",
                     root / "out" / cat / "checkpoints" / "model_best.pth.tar"):
            path.parent.mkdir(parents=True)
            if first is None:
                export_torch_checkpoint(v, str(path))
                first = path
            else:
                path.symlink_to(first)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _data_args(root):
    return ["--num_points", str(N_POINTS), *SMALL, "--cats", *CATS,
            "--splits_path", str(root / "splits"),
            "--data_dir_imgs", str(root / "ShapeNetRendering"),
            "--data_dir_pcl", str(root / "ShapeNet_pointclouds")]


def _assert_tables_match(got, want, exact=False):
    assert got["settings"] == want["settings"]
    assert got["skipped"] == want["skipped"] == sorted((NO_DATA, NO_CKPT))
    assert set(got["categories"]) == set(want["categories"]) == set(CATS)
    for cat, row in want["categories"].items():
        if "skipped" in row:
            assert "skipped" in got["categories"][cat]
            continue
        assert got["categories"][cat]["samples"] == row["samples"] == 24
        for key, rtol in (("cd", CD_RTOL), ("emd", EMD_RTOL)):
            if exact:
                assert got["categories"][cat][key] == row[key], (cat, key)
            else:
                np.testing.assert_allclose(got["categories"][cat][key], row[key], rtol=rtol,
                                           err_msg=f"{cat} {key}")


def test_record_goldens_matches_fenet(goldens_tree, tmp_path):
    """Both CLIs through --torch_model on the same tree and .pth.tar, in the
    strict default mode: the same categories, skips and settings, the
    metrics at the eval tolerances; the skip notes name the same missing
    file and the same empty category. Then the port's --model, on its own
    model_best.pth.tar of the same weights: the same table exactly."""
    root = goldens_tree
    pattern = str(root / "ckpt" / "%s" / "model.pth.tar")
    want = jax_record_goldens(_data_args(root) + ["--torch_model", pattern,
                                                  "--out", str(tmp_path / "fenet.json")])
    got = record_goldens.main(_data_args(root) + ["--torch_model", pattern, "--device", "cpu",
                                                  "--out", str(tmp_path / "port.json")])
    assert json.load(open(tmp_path / "port.json")) == json.loads(json.dumps(got))
    _assert_tables_match(got, want)
    for cat in (NO_DATA, NO_CKPT):
        assert got["categories"][cat] == want["categories"][cat]
    assert want["settings"]["icp"]["rel_tolerance"] == 0.0
    assert got["settings"]["icp"]["patience"] == 0

    own = record_goldens.main(_data_args(root) + [
        "--model", str(root / "out" / "%s" / "checkpoints"), "--device", "cpu",
        "--out", str(tmp_path / "own.json")])
    assert own["settings"]["checkpoints"] == str(root / "out" / "%s" / "checkpoints")
    own["settings"]["checkpoints"] = got["settings"]["checkpoints"]
    _assert_tables_match(own, got, exact=True)
    assert "model_best.pth.tar" in own["categories"][NO_CKPT]["skipped"]


def test_record_goldens_one_file_for_every_category(goldens_tree, tmp_path):
    """A --torch_model without %s is one checkpoint for all: NO_CKPT is
    recorded too, and the fast ICP mode's settings follow --icp_patience."""
    root = goldens_tree
    one = str(root / "ckpt" / CATS[0] / "model.pth.tar")
    got = record_goldens.main(_data_args(root) + [
        "--torch_model", one, "--icp_patience", "32", "--icp_iters", "64", "--cats", NO_CKPT,
        NO_DATA, "--device", "cpu", "--out", str(tmp_path / "one.json")])
    assert got["skipped"] == [NO_DATA]
    assert got["categories"][NO_CKPT]["samples"] == 24
    assert got["settings"]["icp"] == {"iterations": 64, "tolerance": 1e-10,
                                      "rel_tolerance": 1e-6, "patience": 32,
                                      "coarse_points": 0}


def test_record_goldens_processes_agree_on_skips(goldens_tree, tmp_path):
    """Two processes (gloo), one of which misses a category's checkpoint:
    both skip it, the other with the collective-consistency note, both
    record the rest from their shards, and rank 0 alone writes --out."""
    root = goldens_tree
    port = free_port()
    argvs, envs = [], []
    for rank in range(2):
        pattern = str(root / ("ckpt" if rank == 0 else "nowhere") / "%s" / "model.pth.tar")
        if rank == 1:  # rank 1 sees the first category's file only
            os.makedirs(root / "nowhere" / CATS[0], exist_ok=True)
            link = root / "nowhere" / CATS[0] / "model.pth.tar"
            if not link.exists():
                link.symlink_to(root / "ckpt" / CATS[0] / "model.pth.tar")
        argvs.append([sys.executable, "-m", "fenet_torch.cli.record_goldens",
                      *_data_args(root), "--cats", CATS[0], CATS[1],
                      "--torch_model", pattern, "--device", "cpu",
                      "--icp_patience", "32", "--icp_iters", "64",
                      "--out", str(tmp_path / f"rank{rank}.json")])
        envs.append(env(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", FENET_NUM_PROCESSES="2",
                        FENET_PROCESS_ID=str(rank), FENET_DIST_BACKEND="gloo"))
    outputs = run(argvs, envs)
    assert not (tmp_path / "rank1.json").exists()
    table = json.load(open(tmp_path / "rank0.json"))
    assert table["skipped"] == [CATS[1]]
    assert "another process" in table["categories"][CATS[1]]["skipped"]
    assert table["categories"][CATS[0]]["samples"] == 24  # the two shards' sum
    assert all(f"{CATS[1]} SKIPPED" in out for out in outputs)
    single = record_goldens.main(_data_args(root) + [
        "--torch_model", str(root / "ckpt" / "%s" / "model.pth.tar"), "--cats", CATS[0],
        "--icp_patience", "32", "--icp_iters", "64", "--device", "cpu",
        "--out", str(tmp_path / "single.json")])
    # The shards' batches hold other samples than the one process's: CD to
    # 1e-5, EMD to the eval step's 5% (tests/test_torch_parallel.py).
    for key, rtol in (("cd", 1e-5), ("emd", EMD_RTOL)):
        np.testing.assert_allclose(table["categories"][CATS[0]][key],
                                   single["categories"][CATS[0]][key], rtol=rtol)
