"""The rest of fenet in fenet_torch, against fenet on the same inputs: the
RepVGG block helpers and the custom L2, SimpleGenerator, single-cloud ICP
and its SVD best fit, the camera math, the profiling helpers, and the EMD
above 8192 points (the dense auction). Forward only, in one process: data
crosses as numpy arrays.

Tolerances: SimpleGenerator as the Generator (rtol 1e-4, atol 1e-3 on
outputs of magnitude ~1; convolution summation order); the custom L2 rtol
1e-5 (float32 sums in another order); ICP's transform and the best fit
atol 1e-5 (a 3x3 SVD in float32 in each framework), ICP's squared
distances atol 1e-6; the camera math bit for bit (both are the same
numpy); the dense auction's assignments exactly, its distances
bit for bit on dyadic inputs (coordinates k/64: every product and sum
exact) and to 1e-6 on normal ones.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenet.geometry import camera as jax_camera
from fenet.geometry.icp import best_fit_transform as jax_best_fit_transform
from fenet.geometry.icp import icp as jax_icp
from fenet.models.generator import Generator as JaxGenerator
from fenet.models.generator import SimpleGenerator as JaxSimpleGenerator
from fenet.models.generator import init_variables
from fenet.models.repvgg import REPVGG_CONFIGS as JAX_CONFIGS
from fenet.models.repvgg import RepVGG as JaxRepVGG
from fenet.models.repvgg import model_custom_l2 as jax_model_custom_l2
from fenet.ops.emd import earth_mover_distance_ref as jax_emd_ref
from fenet_torch.geometry import camera
from fenet_torch.geometry.icp import best_fit_transform, icp
from fenet_torch.models.convert import state_dict_from_jax
from fenet_torch.models.generator import Generator, SimpleGenerator
from fenet_torch.models.repvgg import REPVGG_CONFIGS, RepVGG, model_custom_l2
from fenet_torch.ops import emd
from fenet_torch.utils import profiling
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

SMALL = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
RTOL, ATOL = 1e-4, 1e-3  # the generators against fenet's, float32
L2_RTOL = 1e-5
ICP_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, b=2):
    return np.random.RandomState(seed).randint(0, 256, (b, 128, 128, 3)).astype(np.float32)


def _randomize_stats(tree, rng):
    """fenet batch_stats with random means and positive variances, so that
    the BN factors of the custom L2 are not all 1."""
    if isinstance(tree, dict):
        return {k: _randomize_stats(v, rng) for k, v in tree.items()}
    return rng.uniform(0.5, 2.0, np.shape(tree)).astype(np.float32)


# -- RepVGG: block names, layer resolution, split forwards, custom L2 --------

LAYER_SPECS = ["stage0", "stage1", "stage2_0", "stage3", "stage4_0", "stage2_13", "stage9",
               "stage", "linear"]


@pytest.mark.parametrize("name", ["RepVGG-TEST", "RepVGG-A2", "RepVGG-B1g2"])
def test_block_names_and_resolution_match_fenet(name):
    ours = RepVGG(REPVGG_CONFIGS[name])
    theirs = JaxRepVGG(config=JAX_CONFIGS[name])
    assert ours.block_names() == theirs.block_names()
    for spec in LAYER_SPECS:
        try:
            want = theirs.resolve_block(spec)
        except ValueError:
            with pytest.raises(ValueError, match="unknown layer"):
                ours.resolve_block(spec)
        else:
            assert ours.resolve_block(spec) == want, spec


@pytest.mark.parametrize("layer", ["stage0", "stage1", "stage2_0", "stage3", "stage4"])
def test_features_split_at_a_block_is_the_whole(layer):
    """Through block ``layer``, then on from it: the final feature map,
    bit for bit, at every block of RepVGG-TEST."""
    torch.manual_seed(0)
    net = RepVGG(REPVGG_CONFIGS["RepVGG-TEST"]).eval()
    x = torch.tensor(_images(1)).permute(0, 3, 1, 2)
    with torch.inference_mode():
        whole = net.forward_features(x)
        split = net.features_from(net.features_up_to(x, layer), layer)
    assert torch.equal(split, whole)


def test_model_custom_l2_matches_fenet():
    model = JaxGenerator(num_points=256, **SMALL)
    v = jax.tree_util.tree_map(np.asarray, init_variables(model, _images(0, 1)))
    v = {"params": v["params"],
         "batch_stats": _randomize_stats(v["batch_stats"], np.random.RandomState(1))}
    want = float(jax_model_custom_l2(v["params"], v["batch_stats"]))
    sd = state_dict_from_jax(v)
    gen = Generator(num_points=256, **SMALL)
    gen.load_state_dict(sd, strict=True)
    for got in (model_custom_l2(sd), model_custom_l2(gen)):
        np.testing.assert_allclose(got.item(), want, rtol=L2_RTOL)
    assert model_custom_l2(gen).requires_grad  # a loss term: it takes gradients


# -- SimpleGenerator ----------------------------------------------------------

def test_simple_generator_matches_fenet():
    model = JaxSimpleGenerator(num_points=256, backbone="RepVGG-TEST")
    v = jax.tree_util.tree_map(np.asarray, init_variables(model, _images(0, 1)))
    v = {"params": v["params"],
         "batch_stats": _randomize_stats(v["batch_stats"], np.random.RandomState(2))}
    images = _images(3)
    want = np.asarray(model.apply(v, jnp.asarray(images), train=False))
    gen = SimpleGenerator(num_points=256, backbone="RepVGG-TEST")
    gen.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.inference_mode():
        got = gen.eval()(torch.tensor(images)).numpy()
    assert got.shape == want.shape == (2, 256, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- single-cloud ICP and the SVD best fit -----------------------------------

def _rotation(theta):
    return np.array([[np.cos(theta), -np.sin(theta), 0], [np.sin(theta), np.cos(theta), 0],
                     [0, 0, 1]], np.float32)


@pytest.mark.parametrize("reflect", [False, True])
def test_best_fit_transform_matches_fenet(reflect):
    """fenet's rigid-motion case, and a mirrored target, whose SVD
    rotation has det -1 until the reflection fix."""
    rng = np.random.RandomState(6)
    a = rng.rand(64, 3).astype(np.float32)
    b = a @ _rotation(0.4).T + np.array([0.1, -0.2, 0.3], np.float32)
    if reflect:
        b = (b * np.array([1, 1, -1], np.float32)).astype(np.float32)
    want = np.asarray(jax_best_fit_transform(jnp.asarray(a), jnp.asarray(b)))
    got = best_fit_transform(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ICP_ATOL)
    assert np.isclose(np.linalg.det(got[:3, :3]), 1.0, atol=1e-5)
    if not reflect:
        np.testing.assert_allclose(got[:3, :3], _rotation(0.4), atol=1e-4)


@pytest.mark.parametrize("max_iterations,tolerance", [(20, 0.001), (64, 1e-10)])
def test_icp_matches_fenet(max_iterations, tolerance):
    """fenet's rotated-cloud case, one cloud: the transform, the final
    distances and the iteration count."""
    rng = np.random.RandomState(7)
    gt = rng.rand(256, 3).astype(np.float32)
    pred = (gt @ _rotation(0.2).T + 0.05).astype(np.float32)
    t_j, d_j, it_j = jax_icp(jnp.asarray(pred), jnp.asarray(gt),
                             max_iterations=max_iterations, tolerance=tolerance)
    t_t, d_t, it_t = icp(torch.tensor(pred), torch.tensor(gt),
                         max_iterations=max_iterations, tolerance=tolerance)
    assert it_t == int(it_j)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=0, atol=ICP_ATOL)
    # Squared: at an exact match the squared distance is float32 noise of
    # |a|² + |b|² - 2ab (~4e-7 here), which the square root lifts to ~6e-4.
    np.testing.assert_allclose(d_t.numpy() ** 2, np.asarray(d_j) ** 2, rtol=0, atol=1e-6)
    moved = pred @ t_t[:3, :3].numpy().T + t_t[:3, 3].numpy()
    assert np.abs(moved - gt).mean() < 0.2 * np.abs(pred - gt).mean()


# -- camera: the same numpy, bit for bit --------------------------------------

def _same(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
        return
    assert np.asarray(a).dtype == np.asarray(b).dtype
    np.testing.assert_array_equal(a, b)


CAMERA_CASES = {
    "get_blender_proj": [(13.6, 44.1, 0.725), (200.4, 31.0, 0.97, 128, 96)],
    "rotation_matrix_x": [(0.7,), (-np.pi / 2,)],
    "rotation_matrix_y": [(0.7,)],
    "rotation_matrix_z": [(0.7,)],
    "get_rotate_matrix": [(-np.pi / 2,), (0.3,)],
    "get_w2o_mat": [((0.1, -0.2, 0.3),)],
    "degree2rad": [(row,) for row in jax_camera.PARAMS[:3]],
    "camera_info": [(jax_camera.degree2rad(row),) for row in jax_camera.PARAMS[3:5]],
    "get_img_cam": [(row,) for row in jax_camera.PARAMS[5:8]],
    "view_transform": [(row,) for row in jax_camera.PARAMS[::7]]
    + [(jax_camera.PARAMS[1], 224, 224, np.diag([2.0, 2.0, 2.0, 1.0]))],
    "normalize_imagenet": [(np.random.RandomState(0).rand(2, 4, 4, 3).astype(np.float32),)],
}


@pytest.mark.parametrize("name", sorted(CAMERA_CASES))
def test_camera_function_matches_fenet(name):
    for args in CAMERA_CASES[name]:
        _same(getattr(camera, name)(*args), getattr(jax_camera, name)(*args))


def test_camera_projections_and_constants_match_fenet():
    for const in ("PARAMS", "ROT90Y", "CAM_ROT", "F_MM", "SENSOR_SIZE_MM", "CAM_MAX_DIST"):
        _same(getattr(camera, const), getattr(jax_camera, const))
    rng = np.random.RandomState(1)
    pts = rng.rand(32, 3) - 0.5
    trans = camera.view_transform(camera.PARAMS[4])
    _same(camera.project_points(pts, trans), jax_camera.project_points(pts, trans))
    k, rt = camera.get_blender_proj(48.2, 5.6, 0.87)
    _same(camera.get_img_points(pts, k, rt), jax_camera.get_img_points(pts, k, rt))
    for transform in (rng.rand(2, 3, 4), rng.rand(2, 3, 3)):
        clouds = rng.rand(2, 16, 3)
        _same(camera.transform_points(clouds, transform),
              jax_camera.transform_points(clouds, transform))


def test_camera_files_match_fenet(tmp_path):
    """reproject_views' overlays byte for byte, and get_norm_matrix from an
    SDF sample file."""
    import cv2
    import h5py

    rng = np.random.RandomState(2)
    for side in ("port", "fenet"):
        (tmp_path / side).mkdir()
        for i in range(3):
            cv2.imwrite(str(tmp_path / side / f"{i:02d}.png"),
                        rng.randint(0, 255, (128, 128, 3), np.uint8) if side == "port"
                        else cv2.imread(str(tmp_path / "port" / f"{i:02d}.png")))
    pts = np.random.RandomState(3).rand(5, 3) * 0.2
    got = camera.reproject_views(str(tmp_path / "port"), points=pts, params=camera.PARAMS[:4])
    want = jax_camera.reproject_views(str(tmp_path / "fenet"), points=pts,
                                      params=jax_camera.PARAMS[:4])
    assert len(got) == len(want) == 3  # view 03.png is absent: the loop stops there
    for a, b in zip(got, want):
        _same(a, b)
    for i in range(3):
        assert ((tmp_path / "port" / f"{i:02d}_out.png").read_bytes()
                == (tmp_path / "fenet" / f"{i:02d}_out.png").read_bytes())
    path = str(tmp_path / "sdf.h5")
    with h5py.File(path, "w") as f:
        f["norm_params"] = np.array([0.1, -0.2, 0.05, 1.7])
    _same(camera.get_norm_matrix(path), jax_camera.get_norm_matrix(path))


# -- profiling: fenet's tests/test_profiling.py cases ------------------------

def test_synced_seconds_times_and_calls_each_time():
    calls = []

    def wrapped(x):
        calls.append(1)
        return (x * 2).sum()

    assert profiling.synced_seconds(wrapped, torch.ones(64, 64), iters=3, warmup=2) >= 0.0
    assert len(calls) == 5  # warmup + iters, every call made


def test_synced_seconds_handles_nests_and_scalars():
    t = profiling.synced_seconds(lambda x: {"a": x + 1, "n": 3, "l": [x, (x, 2.0)]},
                                 torch.zeros(4), iters=1, warmup=0)
    assert t >= 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    d = str(tmp_path / "trace")
    with profiling.trace(d) as prof:
        torch.arange(128.0).sum()
    files = [f for _, _, fs in os.walk(d) for f in fs]
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(os.path.join(d, files[0])))["traceEvents"]
    assert any("aten::sum" in e.get("name", "") for e in events)
    assert any(e.key == "aten::sum" for e in prof.key_averages())


# -- EMD above 8192 points: the dense auction ---------------------------------

def _cloud(kind, rng, *shape):
    if kind == "dyadic":
        return (rng.randint(-64, 65, size=shape) / 64.0).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


# (eps, iters, scale_phases, early_exit, scale_thresh, clustered x1): the
# fixed-eps auction with and without its early exit, eps-scaling always on,
# and with the adaptive gate open (clustered predictions) and closed.
DENSE_CASES = {
    "fixed": (0.005, 50, 1, True, 0.0, False),
    "fixed_all_iters": (0.05, 60, 1, False, 0.0, False),
    "scaled": (0.05, 200, 3, True, 0.0, True),
    "gate_open": (0.05, 200, 3, True, 0.3, True),
    "gate_closed": (0.05, 200, 3, False, 0.3, False),
}


@pytest.mark.parametrize("kind", ["dyadic", "normal"])
@pytest.mark.parametrize("case", sorted(DENSE_CASES))
def test_dense_auction_matches_fenets_xla_auction(kind, case):
    """earth_mover_distance_ref against fenet's at N = 256 (the function
    does not depend on N): equal assignments. The chunk of elements is
    forced to 1, so the elements run one at a time, as above 8192 points."""
    eps, iters, phases, early_exit, thresh, clustered = DENSE_CASES[case]
    rng = np.random.RandomState(12)
    x1, x2 = _cloud(kind, rng, 3, 256, 3), _cloud(kind, rng, 3, 256, 3)
    if clustered:
        x1 = (np.round(x1 * 4) / 256 if kind == "dyadic" else x1 * 0.05).astype(np.float32)
    d_j, a_j = jax_emd_ref(jnp.asarray(x1), jnp.asarray(x2), eps, iters, phases, early_exit,
                           thresh)
    calls = emd.earth_mover_distance_ref.calls
    pairs = emd.DENSE_PAIRS
    emd.DENSE_PAIRS = 256 * 256
    try:
        d_t, a_t = emd.earth_mover_distance_ref(torch.tensor(x1), torch.tensor(x2), eps, iters,
                                                phases, early_exit, thresh)
    finally:
        emd.DENSE_PAIRS = pairs
    assert emd.earth_mover_distance_ref.calls == calls + 1
    assert a_t.dtype == torch.int32 and a_t.shape == (3, 256)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    if kind == "dyadic":
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    else:
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0, atol=1e-6)


def test_emd_above_8192_points_runs_the_dense_auction(monkeypatch, caplog):
    """N = 8193 through the public op: neither the kernel nor its plain
    version is asked, the dense auction runs, and the warning is logged
    once for the N."""
    def refuse(*args):
        raise AssertionError("the kernel path was asked above 8192 points")

    monkeypatch.setattr(emd, "auction_kernel", refuse)
    monkeypatch.setattr(emd, "_auction_plain", refuse)
    monkeypatch.setattr(emd, "_warned_dense", set())
    rng = np.random.RandomState(13)
    n = emd.MAX_N + 1
    x1, x2 = (torch.tensor(rng.rand(1, n, 3).astype(np.float32)) for _ in range(2))
    calls = emd.earth_mover_distance_ref.calls
    with caplog.at_level(logging.WARNING, logger="fenet_torch.ops.emd"):
        for _ in range(2):
            dist, ass = emd.earth_mover_distance(x1, x2, 0.05, 1)
    assert emd.earth_mover_distance_ref.calls == calls + 2
    assert dist.shape == ass.shape == (1, n) and ass.dtype == torch.int32
    assert torch.isfinite(dist).all() and bool(((ass >= 0) & (ass < n)).all())
    declined = [r for r in caplog.records if f"N={n}" in r.getMessage()]
    assert len(declined) == 1
