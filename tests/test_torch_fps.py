"""fenet_torch's farthest-point sampling, index_points, sample_model_cloud,
prepare_splits and the prepare_data CLI against fenet's, on the CPU.

Tolerance: exact. FPS indices must equal fenet's jitted FPS, including on
clouds with duplicated points (exact ties: the first index wins) and on a
planted near-tie that the squared distance's float32 roundings decide
(fenet's XLA computes it as fused multiply-adds). The files prepare_data
writes must equal fenet's byte for byte, as must the number of models
written under the skip and overwrite rules.
"""

import random
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenet.cli import prepare_data as jax_prepare_data
from fenet.data.sample_pcl import prepare_splits as jax_prepare_splits
from fenet.data.sample_pcl import sample_model_cloud as jax_sample_model_cloud
from fenet.ops.fps import farthest_point_sample as jax_fps
from fenet.ops.fps import index_points as jax_index_points
from fenet_torch.cli import prepare_data
from fenet_torch.data.sample_pcl import VIEWPOINTS, prepare_splits, sample_model_cloud
from fenet_torch.data.shapenet import load_split
from fenet_torch.data.synthetic import write_synthetic_shapenet
from fenet_torch.ops.fps import farthest_point_sample, index_points

CAT = "02691156"


def _fps_both(xyz, npoint, ran):
    got = farthest_point_sample(torch.from_numpy(xyz), npoint, ran).numpy()
    want = np.asarray(jax_fps(jnp.asarray(xyz), npoint, ran=ran))
    return got, want


@pytest.mark.parametrize("ran", [True, False])
@pytest.mark.parametrize("npoint", [64, 128, 256])
@pytest.mark.parametrize("n", [200, 1024])
def test_fps_indices_match_fenet(n, npoint, ran):
    xyz = np.random.RandomState(n + npoint).rand(2, n, 3).astype(np.float32)
    got, want = _fps_both(xyz, npoint, ran)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["halves", "grid", "one_point"])
def test_fps_ties_match_fenet(kind):
    """Duplicated points make exact ties at the argmax."""
    rng = np.random.RandomState(3)
    if kind == "halves":  # every point twice
        xyz = rng.rand(2, 128, 3).astype(np.float32)
        xyz = np.concatenate([xyz, xyz], axis=1)
    elif kind == "grid":  # many equal distances
        g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"), -1).reshape(-1, 3)
        xyz = np.stack([g, g[::-1]]).astype(np.float32) / 8
    else:  # all points equal: every distance 0 after the first
        xyz = np.ones((2, 64, 3), np.float32)
    for ran in (True, False):
        got, want = _fps_both(xyz, 128, ran)
        np.testing.assert_array_equal(got, want)


def test_fps_near_tie_follows_fused_rounding():
    """Points 1 and 2 are permutations of one another: (a+b)+c would make 2
    the farther from point 0; fenet's fused multiply-adds make them tie,
    and the first index wins."""
    xyz = np.zeros((1, 8, 3), np.float32)
    xyz[0, 1] = [0.60222614, 0.9390587, 0.5136938]
    xyz[0, 2] = xyz[0, 1, [1, 2, 0]]
    xyz[0, 3:] = np.random.RandomState(1).uniform(-0.1, 0.1, (5, 3))
    sq = xyz[0, 1:3] ** 2
    assert (sq[0, 0] + sq[0, 1]) + sq[0, 2] < (sq[1, 0] + sq[1, 1]) + sq[1, 2]
    got, want = _fps_both(xyz, 3, True)
    np.testing.assert_array_equal(want, [[0, 1, 2]])
    np.testing.assert_array_equal(got, want)


def test_index_points_matches_fenet():
    rng = np.random.RandomState(1)
    pts = rng.rand(2, 50, 3).astype(np.float32)
    idx = rng.randint(0, 50, size=(2, 7))
    got = index_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    want = np.asarray(jax_index_points(jnp.asarray(pts), jnp.asarray(idx)))
    assert got.tobytes() == want.tobytes()


def test_sample_model_cloud_matches_fenet():
    pcl = np.random.RandomState(2).rand(1024, 3).astype(np.float32) - 0.5
    ours, ref = random.Random(7), random.Random(7)
    for _ in range(len(VIEWPOINTS) + 1):  # every viewpoint is drawn
        got = sample_model_cloud(pcl, ours, "cpu")
        want = jax_sample_model_cloud(pcl, ref)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert ours.getstate() == ref.getstate()


@pytest.fixture()
def trees(tmp_path):
    """Two copies of one synthetic tree, one for each package, with the
    128/256-point files removed for every model but the first."""
    roots = [tmp_path / "ours", tmp_path / "ref"]
    write_synthetic_shapenet(str(roots[0]), cats=(CAT,), models_per_cat=4, num_points=1024)
    shutil.copytree(roots[0], roots[1])
    models = load_split(str(roots[0] / "splits"), "train_models.json")
    for root in roots:
        for model in models[CAT][1:]:
            for n in (128, 256):
                (root / "ShapeNet_pointclouds" / model / f"pointcloud_{n}.npy").unlink()
    return roots, models


def _files(root, models):
    return {f"{m}/{n}": (root / "ShapeNet_pointclouds" / m / f"pointcloud_{n}.npy").read_bytes()
            for m in models[CAT] for n in (128, 256)}


def test_prepare_splits_matches_fenet(trees):
    """The first model is skipped and draws nothing; the next three are
    written as fenet writes them. Run again: nothing is missing, nothing
    written. With overwrite: all four, as fenet rewrites them."""
    (ours, ref), models = trees
    pcl = [str(r / "ShapeNet_pointclouds") + "/" for r in (ours, ref)]
    for overwrite, count in ((False, 3), (False, 0), (True, 4)):
        got = prepare_splits(pcl[0], models, [CAT], seed=5, overwrite=overwrite, device="cpu")
        want = jax_prepare_splits(pcl[1], models, [CAT], seed=5, overwrite=overwrite)
        assert got == want == count
        assert _files(ours, models) == _files(ref, models)


def test_prepare_data_cli_matches_fenet(trees):
    (ours, ref), models = trees
    args = ["--cats", CAT, "--num_points", "1024"]
    for root, main in ((ours, lambda a: prepare_data.main(a + ["--device", "cpu"])),
                       (ref, jax_prepare_data.main)):
        main(args + ["--splits_path", str(root / "splits"),
                     "--data_dir_pcl", str(root / "ShapeNet_pointclouds") + "/"])
    assert _files(ours, models) == _files(ref, models)


def test_prepare_data_default_device_raises_without_a_card(monkeypatch, trees):
    """The CLI runs FPS on the card unless asked for the CPU: with no card
    it raises before it reads or writes anything."""
    (ours, _), models = trees
    before = _files_present(ours, models)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        prepare_data.main(["--splits_path", str(ours / "splits"),
                           "--data_dir_pcl", str(ours / "ShapeNet_pointclouds") + "/"])
    with pytest.raises(RuntimeError, match="cuda"):
        prepare_splits(str(ours / "ShapeNet_pointclouds") + "/", models, [CAT])
    assert _files_present(ours, models) == before


def _files_present(root, models):
    return sorted(p.name for m in models[CAT]
                  for p in (root / "ShapeNet_pointclouds" / m).iterdir())
