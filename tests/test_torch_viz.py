"""The pictures of fenet_torch against fenet's: Grad-CAM at the final
feature map, at a block and at a stage prefix; the matplotlib renders,
pixel for pixel; and the render, render_pix3d and heatmap CLIs on the same
trees and weights, file for file.

Grad-CAM runs a torch backward, and torch autograd and XLA:CPU corrupt the
heap when both run in one process: the port's CAMs come from this file run
as a script (``python tests/test_torch_viz.py <in.npz> <out.npz>``, which
imports no JAX), and its heatmap CLI from a subprocess.

Tolerances: the normalised CAMs atol 1e-4 (the generators' float32 outputs
differ by convolution summation order, and the CAM is a ratio of sums of
their gradients); the overlays' uint8 pixels by at most 3 (255·cam can
round to the neighbouring colormap entry at that gap, OVERLAY_ATOL); the
renders pixel for pixel (the same matplotlib on the same clouds).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
N_POINTS = 256
# None: the final feature map; a block name; a stage prefix (its last block).
CAM_LAYERS = ["final", "stage2_0", "stage3"]


def _port_cams(in_path: str, out_path: str) -> None:
    """The port's Grad-CAM of the input's image for each of CAM_LAYERS, from
    the weights of the input's .pth.tar."""
    from fenet_torch.models.convert import load_reference_checkpoint
    from fenet_torch.models.generator import Generator
    from fenet_torch.viz.gradcam import grad_cam

    torch.set_num_threads(1)
    blob = np.load(in_path)
    gen = load_reference_checkpoint(Generator(num_points=N_POINTS, **SMALL),
                                    str(blob["ckpt"])).eval()
    with torch.inference_mode():  # grad_cam leaves the caller's inference mode
        cams = {layer: grad_cam(gen, blob["image"], layer=None if layer == "final" else layer)
                for layer in CAM_LAYERS}
    np.savez(out_path, **cams)


if __name__ == "__main__":
    _port_cams(sys.argv[1], sys.argv[2])
    raise SystemExit(0)

import jax  # noqa: E402
import pytest  # noqa: E402

from fenet.cli.eval_pix3d import PIX3D_TO_SHAPENET as JAX_PIX3D_TO_SHAPENET  # noqa: E402
from fenet.cli.heatmap import main as jax_heatmap  # noqa: E402
from fenet.cli.render import main as jax_render  # noqa: E402
from fenet.cli.render_pix3d import main as jax_render_pix3d  # noqa: E402
from fenet.models.generator import Generator as JaxGenerator  # noqa: E402
from fenet.models.generator import init_variables  # noqa: E402
from fenet.train.checkpoint import export_torch_checkpoint, save_checkpoint  # noqa: E402
from fenet.viz import gradcam as jax_gradcam  # noqa: E402
from fenet.viz import render as jax_render_lib  # noqa: E402
from fenet_torch.cli import render, render_pix3d  # noqa: E402
from fenet_torch.cli.eval_pix3d import PIX3D_TO_SHAPENET  # noqa: E402
from fenet_torch.data.synthetic import write_synthetic_pix3d, write_synthetic_shapenet  # noqa: E402
from fenet_torch.viz import gradcam  # noqa: E402
from fenet_torch.viz import render as render_lib  # noqa: E402
from torch_ranks import env  # noqa: E402
from torch_tmp import remove_tmp_path  # noqa: E402,F401  (deletes each test's tmp_path)

CAM_ATOL = 1e-4
# An overlay pixel: 255·cam may round to the next colormap index, and JET's
# neighbouring entries differ by up to 5 in a channel; blended at alpha 0.4
# that is 2, and the blend's own rounding 1 more.
OVERLAY_ATOL = 3
CAT = "02828884"
ARCH = ["--num_points", str(N_POINTS), "--backbone", "RepVGG-TEST", "--fine_width", "32",
        "--mid_width", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables():
    """fenet's small generator, output heads scaled by 1e-3 (a unit-scale
    cloud, as a trained model's), as numpy."""
    model = JaxGenerator(num_points=N_POINTS, **SMALL)
    v = jax.tree_util.tree_map(np.asarray, init_variables(
        model, np.zeros((1, 128, 128, 3), np.float32)))
    for name in ("fc3_1", "conv2_1", "conv1_3"):
        for leaf in ("kernel", "bias"):
            v["params"]["decoder"][name][leaf] = (
                v["params"]["decoder"][name][leaf] * np.float32(1e-3))
    return model, {"params": v["params"], "batch_stats": v["batch_stats"]}


def _save_both(v, ckpt_dir: Path, cat: str):
    """fenet's model_best.ckpt and the port's model_best.pth.tar of ``v``."""
    save_checkpoint({**v, "epoch": 1}, True, cat, str(ckpt_dir), 1)
    export_torch_checkpoint(v, str(ckpt_dir / "model_best.pth.tar"))


@pytest.fixture(scope="module")
def shapenet(tmp_path_factory):
    """A one-model synthetic tree of CAT and both packages' checkpoints of
    one small generator under ``out/CAT/checkpoints``; (root, model,
    variables)."""
    import shutil

    root = tmp_path_factory.mktemp("viz")
    write_synthetic_shapenet(str(root), cats=(CAT,), models_per_cat=1, num_points=N_POINTS)
    model, v = _variables()
    _save_both(v, root / "out" / CAT / "checkpoints", CAT)
    yield root, model, v
    shutil.rmtree(root, ignore_errors=True)


def _tree_args(root):
    return ["--category", CAT, *ARCH, "--model", str(root / "out" / "%s" / "checkpoints"),
            "--splits_path", str(root / "splits"),
            "--data_dir_imgs", str(root / "ShapeNetRendering"),
            "--data_dir_pcl", str(root / "ShapeNet_pointclouds")]


def _names(path: Path):
    return sorted(str(p.relative_to(path)) for p in path.rglob("*.png"))


def _pixels(path):
    import cv2

    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED)


# -- Grad-CAM -------------------------------------------------------------------

def test_grad_cam_matches_fenet(shapenet, tmp_path):
    root, model, v = shapenet
    image = np.random.RandomState(3).randint(0, 256, (1, 128, 128, 3)).astype(np.float32)
    np.savez(tmp_path / "in.npz", image=image,
             ckpt=str(root / "out" / CAT / "checkpoints" / "model_best.pth.tar"))
    subprocess.run([sys.executable, __file__, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, env=env(), timeout=300)
    got = np.load(tmp_path / "out.npz")
    for layer in CAM_LAYERS:
        want = jax_gradcam.grad_cam(model, v, image, layer=None if layer == "final" else layer)
        assert got[layer].shape == want.shape == (128, 128), layer
        assert got[layer].dtype == np.float32
        assert 0.0 <= got[layer].min() and got[layer].max() <= 1.0
        np.testing.assert_allclose(got[layer], want, rtol=0, atol=CAM_ATOL, err_msg=layer)


def test_overlay_heatmap_matches_fenet():
    rng = np.random.RandomState(4)
    image = rng.randint(0, 256, (64, 64, 3)).astype(np.float32)
    cam = rng.rand(64, 64).astype(np.float32)
    for alpha in (0.4, 0.7):
        np.testing.assert_array_equal(gradcam.overlay_heatmap(image, cam, alpha),
                                      jax_gradcam.overlay_heatmap(image, cam, alpha))


def test_heatmap_cli_matches_fenet(shapenet, tmp_path):
    """Both CLIs, without --layer and with a stage prefix: the same files,
    their pixels within OVERLAY_ATOL (the port's in a subprocess: it runs a
    backward)."""
    root, _, _ = shapenet
    for layer in ([], ["--layer", "stage2"]):
        args = _tree_args(root) + ["--n_samples", "2", *layer]
        jax_heatmap(args + ["--out_dir", str(tmp_path / "fenet")])
        subprocess.run([sys.executable, "-m", "fenet_torch.cli.heatmap", *args, "--device",
                        "cpu", "--out_dir", str(tmp_path / "port")],
                       check=True, env=env(), timeout=300, capture_output=True)
    names = _names(tmp_path / "port")
    assert names == _names(tmp_path / "fenet") == [
        f"{CAT}_000_cam.png", f"{CAT}_000_cam_stage2.png", f"{CAT}_001_cam.png",
        f"{CAT}_001_cam_stage2.png"]
    for name in names:
        a, b = _pixels(tmp_path / "port" / name), _pixels(tmp_path / "fenet" / name)
        assert np.abs(a.astype(int) - b.astype(int)).max() <= OVERLAY_ATOL, name


# -- renders --------------------------------------------------------------------

def _clouds():
    rng = np.random.RandomState(5)
    return {"gt": rng.rand(256, 3).astype(np.float32),
            "pred_128": rng.rand(128, 3).astype(np.float32) - 0.5}


def test_render_arrays_match_fenet():
    """render_clouds (with and without the input view) and get_ptcloud_img,
    from numpy and from tensors, pixel for pixel."""
    clouds = _clouds()
    image = np.random.RandomState(6).randint(0, 256, (128, 128, 3)).astype(np.float32)
    as_tensors = {k: torch.tensor(c) for k, c in clouds.items()}
    for view in (None, image):
        want = jax_render_lib.render_clouds(clouds, image=view)
        for ours in (clouds, as_tensors):
            np.testing.assert_array_equal(render_lib.render_clouds(ours, image=view), want)
    want = jax_render_lib.get_ptcloud_img(clouds["gt"], elev=20.0, azim=30.0)
    assert want.dtype == np.uint8 and want.ndim == 3
    for cloud in (clouds["gt"], as_tensors["gt"]):
        np.testing.assert_array_equal(render_lib.get_ptcloud_img(cloud, elev=20.0, azim=30.0),
                                      want)


def test_render_files_match_fenet(tmp_path):
    """save_cloud_png, save_pix3d_cloud_png and render_clouds' file: the same
    pixels as fenet's files."""
    clouds = _clouds()
    render_lib.save_cloud_png(torch.tensor(clouds["gt"]), str(tmp_path / "a_port.png"))
    jax_render_lib.save_cloud_png(clouds["gt"], str(tmp_path / "a_fenet.png"))
    render_lib.save_pix3d_cloud_png(torch.tensor(clouds["gt"]), str(tmp_path / "b_port.png"))
    jax_render_lib.save_pix3d_cloud_png(clouds["gt"], str(tmp_path / "b_fenet.png"))
    render_lib.render_clouds(clouds, path=str(tmp_path / "c_port.png"))
    jax_render_lib.render_clouds(clouds, path=str(tmp_path / "c_fenet.png"))
    for name in "abc":
        np.testing.assert_array_equal(_pixels(tmp_path / f"{name}_port.png"),
                                      _pixels(tmp_path / f"{name}_fenet.png"))


def test_render_cli_matches_fenet(shapenet, tmp_path):
    """Both CLIs, plain and --deploy: the same file names."""
    root, _, _ = shapenet
    for deploy in ([], ["--deploy"]):
        args = _tree_args(root) + ["--n_samples", "2", *deploy]
        sub = "deploy" if deploy else "plain"
        jax_render(args + ["--out_dir", str(tmp_path / "fenet" / sub)])
        render.main(args + ["--device", "cpu", "--out_dir", str(tmp_path / "port" / sub)])
    names = _names(tmp_path / "port")
    assert names == _names(tmp_path / "fenet") == [
        f"{sub}/{CAT}_{i:03d}.png" for sub in ("deploy", "plain") for i in range(2)]


def test_render_pix3d_cli_matches_fenet(tmp_path):
    """Both CLIs on one synthetic Pix3D tree with one generator's weights
    under the mapped ShapeNet ids: the same files; then the skip rule, a
    sample whose gt and prediction both exist is skipped, and one whose
    prediction is missing is written again."""
    cats = ("chair", "table")
    assert PIX3D_TO_SHAPENET == JAX_PIX3D_TO_SHAPENET
    write_synthetic_pix3d(str(tmp_path / "pix3d"), cats=cats, samples_per_cat=3,
                          num_points=N_POINTS)
    _, v = _variables()
    for cat in cats:
        _save_both(v, tmp_path / "out" / PIX3D_TO_SHAPENET[cat] / "checkpoints", cat)
    args = [*ARCH, "--cats", *cats, "--data_dir", str(tmp_path / "pix3d"), "--n_samples", "2",
            "--model", str(tmp_path / "out" / "%s" / "checkpoints")]
    want = jax_render_pix3d(args + ["--out_dir", str(tmp_path / "fenet")])
    got = render_pix3d.main(args + ["--device", "cpu", "--out_dir", str(tmp_path / "port")])
    assert got == want == {"chair": 2, "table": 2}
    names = _names(tmp_path / "port")
    assert names == _names(tmp_path / "fenet") and len(names) == 8
    first = tmp_path / "port" / "chair" / "0000_gt.png"
    np.testing.assert_array_equal(_pixels(first), _pixels(tmp_path / "fenet" / "chair" /
                                                          "0000_gt.png"))

    (tmp_path / "port" / "chair" / "0001_pr.png").unlink()
    again = render_pix3d.main(args + ["--device", "cpu", "--out_dir", str(tmp_path / "port")])
    # chair: 0000 skipped, 0001 written again, 0002 new; table: 0000 and
    # 0001 skipped, 0002 new.
    assert again == {"chair": 2, "table": 1}
    assert (tmp_path / "port" / "chair" / "0001_pr.png").exists()
    assert len(_names(tmp_path / "port")) == 12
