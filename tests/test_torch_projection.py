"""The fenet_torch silhouette projection and its loss against fenet's:
``geometry/pointcloud``, ``geometry/projection`` and ``losses/projection``
on the same numpy inputs, and the gradient of the finetune loss's BCE term
with respect to the prediction against ``jax.grad``.

Torch autograd and XLA:CPU corrupt the heap when both run in one process,
so the port's gradient comes from this file run as a script (``python
tests/test_torch_projection.py <in.npz> <out.npz>``, which imports no JAX).

Tolerances: values to rtol 1e-5 (float32; the splat's product and the
camera matrices sum in another order than XLA's einsum), atol 1e-6 where a
value crosses 0. The gradient of bce_prob(project_silhouettes(pred, gt))
to rtol 1e-3 / atol 1e-6 element by element and 1e-4 in relative L2:
within a few 1e-3 of 1 the raw splat's second log has a gradient of
1/(1 - pred), which turns the inputs' float32 rounding into a few 1e-4
relative (measured below these limits on every case here).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
GRID, SIGMA_SQ = 64, 2.0  # the finetune defaults
SQUASH = (False, True)


def _port_grads(in_path: str, out_path: str) -> None:
    """The port's gradients, for each squash setting: of the BCE term with
    respect to each case's pred; of project_silhouettes' pred output against
    a cotangent (its VJP); of bce_prob with respect to given silhouettes."""
    from fenet_torch.geometry.projection import project_silhouettes
    from fenet_torch.losses.projection import get_loss_proj

    blob = np.load(in_path)
    out = {}
    for squash in SQUASH:
        for case in range(len(blob["pred"])):
            pred = torch.tensor(blob["pred"][case], requires_grad=True)
            proj_pred, proj_gt = project_silhouettes(pred, torch.tensor(blob["gt"][case]), GRID,
                                                     GRID, SIGMA_SQ, squash=squash)
            loss = get_loss_proj(proj_pred, proj_gt, "bce_prob")[0]
            loss.backward()
            out[f"loss_{case}_{squash}"] = loss.detach().numpy()
            out[f"grad_{case}_{squash}"] = pred.grad.numpy()
        pred = torch.tensor(blob["vjp_pred"], requires_grad=True)
        proj_pred, _ = project_silhouettes(pred, torch.tensor(blob["vjp_gt"]), GRID, GRID,
                                           SIGMA_SQ, squash=squash)
        (proj_pred * torch.tensor(blob["cotangent"])).sum().backward()
        out[f"vjp_{squash}"] = pred.grad.numpy()
    sil = torch.tensor(blob["sil_pred"], requires_grad=True)
    get_loss_proj(sil, torch.tensor(blob["sil_gt"]), "bce_prob", w=2.5)[0].backward()
    out["sil_grad"] = sil.grad.numpy()
    np.savez(out_path, **out)


if __name__ == "__main__":
    torch.set_num_threads(1)
    _port_grads(sys.argv[1], sys.argv[2])
    raise SystemExit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from fenet.data.synthetic import _random_cloud  # noqa: E402
from fenet.geometry import pointcloud as jax_pc  # noqa: E402
from fenet.geometry import projection as jax_proj  # noqa: E402
from fenet.losses import projection as jax_loss  # noqa: E402
from fenet_torch.geometry import pointcloud, projection  # noqa: E402
from fenet_torch.losses import projection as loss  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _clouds(seed, b=2, n=256):
    """Object-like clouds (a few gaussian clusters, as the synthetic data
    has) and uniform ones, (b, n, 3) float32 each."""
    rng = np.random.RandomState(seed)
    blob = np.stack([_random_cloud(rng, n) for _ in range(b)])
    uniform = (rng.rand(b, n, 3) * 0.9 - 0.45).astype(np.float32)
    return blob, uniform


def _close(got, want, rtol=RTOL, atol=ATOL, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol,
                               **kw)


def test_rotate_and_preprocess_match_fenet():
    blob, _ = _clouds(0)
    angle = np.pi / 180.0 * -90
    for args in ((angle, angle), (angle,), (0.3, -1.1, 2.0)):
        np.testing.assert_array_equal(pointcloud.rotate(blob[0], *args),
                                      jax_pc.rotate(blob[0], *args))
    _close(pointcloud.preprocess_pcl_gt(torch.tensor(blob)),
           jax_pc.preprocess_pcl_gt(jnp.asarray(blob)), rtol=0, atol=0)


@pytest.mark.parametrize("kind", [0, 1], ids=["blob", "uniform"])
def test_pointcloud_ops_match_fenet(kind):
    p = _clouds(1)[kind]
    t, j = torch.tensor(p), jnp.asarray(p)
    got, want = pointcloud.average_pcl(t), jax_pc.average_pcl(j)
    for g, w in zip(got, want):
        _close(g, w)
    out = pointcloud.outlier(*got)
    _close(out, jax_pc.outlier(*want))
    # Every (element, axis) has exactly one overwritten point, at the first
    # argmax, holding the pre-centring mean.
    idx = got[0].argmax(dim=1)
    for b in range(p.shape[0]):
        for a in range(3):
            assert float(out[b, idx[b, a], a]) == float(got[1 + a])
    _close(pointcloud.scale2one(out), jax_pc.scale2one(jnp.asarray(out.numpy())))
    for g, w in zip(pointcloud.normalize_to_unit_cube(t), jax_pc.normalize_to_unit_cube(j)):
        _close(g, w)


def test_camera_transforms_match_fenet():
    p, _ = _clouds(2)
    az, el = np.float32([0.4, -1.2]), np.float32([0.3, 0.05])
    cam = projection.world2cam(torch.tensor(p), torch.tensor(az), torch.tensor(el))
    _close(cam, jax_proj.world2cam(jnp.asarray(p), jnp.asarray(az), jnp.asarray(el)))
    # az = el = 0 (the finetune path): a translation, exactly.
    cam0 = projection.world2cam(torch.tensor(p), 0.0, 0.0)
    _close(cam0, jax_proj.world2cam(jnp.asarray(p), 0.0, 0.0), rtol=0, atol=0)
    _close(projection.perspective_transform(cam),
           jax_proj.perspective_transform(jnp.asarray(cam.numpy())))


@pytest.mark.parametrize("squash", SQUASH)
def test_splats_match_fenet(squash):
    rng = np.random.RandomState(3)
    p = (rng.rand(2, 256, 3) * 2 - 1).astype(np.float32)
    for grid_h, grid_w, sigma_sq in ((64, 64, 2.0), (16, 24, 0.5)):
        got = projection.cont_proj(torch.tensor(p), grid_h, grid_w, sigma_sq, squash=squash)
        want = jax_proj.cont_proj(jnp.asarray(p), grid_h, grid_w, sigma_sq, squash=squash)
        assert tuple(got.shape) == (2, grid_h, grid_w)
        _close(got, want)
    # disc_proj takes grid coordinates; some fall outside and are clipped.
    g = (rng.rand(2, 256, 3) * 80 - 8).astype(np.float32)
    _close(projection.disc_proj(torch.tensor(g), 64, 48), jax_proj.disc_proj(jnp.asarray(g), 64, 48),
           rtol=0, atol=0)
    x = rng.randn(5, 7).astype(np.float32)
    _close(projection.apply_kernel(torch.tensor(x), 0.7), jax_proj.apply_kernel(jnp.asarray(x), 0.7))


@pytest.mark.parametrize("squash", SQUASH)
def test_project_silhouettes_match_fenet(squash):
    for pred, gt in (_clouds(4), _clouds(5)[::-1]):
        got = projection.project_silhouettes(torch.tensor(pred), torch.tensor(gt), GRID, GRID,
                                             SIGMA_SQ, squash=squash)
        want = jax_proj.project_silhouettes(jnp.asarray(pred), jnp.asarray(gt), GRID, GRID,
                                            SIGMA_SQ, squash=squash)
        for g, w in zip(got, want):
            _close(g, w)
        if not squash:  # the raw splat is no probability
            assert float(got[0].max()) > 1.0
    # The batch-global centring couples the elements: element 0's
    # silhouette moves when element 1 does.
    pred, gt = _clouds(4)
    moved = pred.copy()
    moved[1] += 0.2
    a = projection.project_silhouettes(torch.tensor(pred), torch.tensor(gt), GRID, GRID, SIGMA_SQ)
    b = projection.project_silhouettes(torch.tensor(moved), torch.tensor(gt), GRID, GRID, SIGMA_SQ)
    assert not torch.equal(a[0][0], b[0][0])


@pytest.mark.parametrize("loss_type", ["bce", "weighted_bce", "bce_prob"])
def test_get_loss_proj_matches_fenet(loss_type):
    """Each mode on fenet's silhouettes of 16x16, with the min-distance
    affinity terms (their (B, 16, 16, 16, 16) tensors are small at this
    grid). Both sides take identical silhouettes: the terms' masks multiply
    1 - silhouette by 1e6, which would turn the projections' float32
    rounding (~1e-7) into ~0.1."""
    pred, gt = _clouds(6)
    sq = loss_type == "bce"  # bce clips its input to (0, 1)
    p_j, g_j = jax_proj.project_silhouettes(jnp.asarray(pred), jnp.asarray(gt), 16, 16,
                                            SIGMA_SQ, squash=sq)
    p_t, g_t = torch.tensor(np.asarray(p_j)), torch.tensor(np.asarray(g_j))
    got = loss.get_loss_proj(p_t, g_t, loss_type, min_dist_loss=True, grid_h=16, grid_w=16)
    want = jax_loss.get_loss_proj(p_j, g_j, loss_type, min_dist_loss=True, grid_h=16, grid_w=16)
    for g, w in zip(got, want):
        _close(g, w)
    assert tuple(got[1].shape) == (2, 16, 16)
    got = loss.get_loss_proj(p_t, g_t, loss_type, w=2.5)[0]
    _close(got, jax_loss.get_loss_proj(p_j, g_j, loss_type, w=2.5)[0])
    np.testing.assert_array_equal(loss.grid_dist(16, 12), jax_loss.grid_dist(16, 12))
    with pytest.raises(ValueError, match="loss_type"):
        loss.get_loss_proj(p_t, g_t, "l2")


def test_bce_prob_floor_matches_fenet():
    """Cells below, at and past 1, where the floor decides the value."""
    pred, gt = _floor_cells()
    got, _, _ = loss.get_loss_proj(torch.tensor(pred), torch.tensor(gt), "bce_prob")
    want, _, _ = jax_loss.get_loss_proj(jnp.asarray(pred), jnp.asarray(gt), "bce_prob")
    _close(got, want)
    assert np.isfinite(float(got))


def _floor_cells():
    """(1, 2, 8) silhouettes with cells around 1 - 1e-8 (1 and 1 - 6e-8,
    which round to float32s that the floor decides), past 1 and far from
    it, and their targets."""
    pred = np.float32([[0.5, 1.0 - 1e-7, 1.0, 1.0 + 1e-7, 1.0 - 6e-8, 2.5, 1e-9, 0.999],
                       [1.3, 0.0, 1.0, 0.25, 7.0, 1.0 - 3e-7, 1.0 + 2e-6, 0.9]])[None]
    gt = np.float32([[1.0, 0.0, 0.5, 0.0, 0.0, 0.0, 0.0, 1.0],
                     [2.0, 1.0, 0.0, 1.0, 0.0, 0.3, 1.0, 0.0]])[None]
    return pred, gt


def _jax_port_grads(tmp_path, pred, gt, vjp_pred, vjp_gt, cotangent, sil_pred, sil_gt):
    np.savez(tmp_path / "in.npz", pred=pred, gt=gt, vjp_pred=vjp_pred, vjp_gt=vjp_gt,
             cotangent=cotangent, sil_pred=sil_pred, sil_gt=sil_gt)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, __file__, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, cwd=REPO, env=env, timeout=300)
    return np.load(tmp_path / "out.npz")


def test_bce_prob_gradient_matches_jax_grad(tmp_path):
    """The gradient of the finetune loss's BCE term with respect to the
    prediction, against jax.grad, squash off and on, in three parts:

    - d loss / d silhouette at identical silhouettes, with cells at the
      floor and past 1 (elementwise; the floored cells get no gradient);
    - project_silhouettes' VJP against one cotangent (the smooth part);
    - the whole term on object-like and uniform clouds whose raw silhouettes
      exceed 1. There a cell's gradient is 1/(1 - pred), so each cell near 1
      turns the float32 rounding of its value (a few 1e-7 of it, different
      in each framework) into a relative error of rounding / |1 - pred|:
      the term is ill-conditioned in float32 itself. The relative L2
      tolerance of each case is set from that: 1e-4 + 4·2^-23·max(pred) /
      min |1 - pred| over the cells the floor leaves (and the loss's value
      to that over the number of cells). Every case is held to it, and the best-conditioned of them must have a tolerance of 1e-2 or
      less (ROADMAP Queue 3 has the sizes).
    """
    cases = [_clouds(7), _clouds(8)[::-1]]
    pred = np.stack([c[0] for c in cases])
    gt = np.stack([c[1] for c in cases])
    vjp_pred, vjp_gt = _clouds(12)
    cotangent = np.random.RandomState(13).randn(2, GRID, GRID).astype(np.float32)
    sil_pred, sil_gt = _floor_cells()
    tols = []
    got = _jax_port_grads(tmp_path, pred, gt, vjp_pred, vjp_gt, cotangent, sil_pred, sil_gt)

    want = jax.grad(lambda s: jax_loss.get_loss_proj(s, jnp.asarray(sil_gt), "bce_prob",
                                                     w=2.5)[0])(jnp.asarray(sil_pred))
    np.testing.assert_allclose(got["sil_grad"], np.asarray(want), rtol=1e-6, atol=0)
    floored = np.abs(1 - sil_pred - np.float32(1e-8)) < np.float32(1e-7)
    assert floored.sum() >= 3 and not np.any(got["sil_grad"][floored & (sil_gt == 0)])
    for squash in SQUASH:
        _, vjp = jax.vjp(lambda p, squash=squash: jax_proj.project_silhouettes(
            p, jnp.asarray(vjp_gt), GRID, GRID, SIGMA_SQ, squash=squash)[0],
            jnp.asarray(vjp_pred))
        (want,) = vjp(jnp.asarray(cotangent))
        np.testing.assert_allclose(got[f"vjp_{squash}"], np.asarray(want), rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(), err_msg=f"squash {squash}")
        for case in range(len(cases)):
            def bce(p, squash=squash, case=case):
                pp, pg = jax_proj.project_silhouettes(p, jnp.asarray(gt[case]), GRID, GRID,
                                                      SIGMA_SQ, squash=squash)
                return jax_loss.get_loss_proj(pp, pg, "bce_prob")[0]

            value, grad = jax.value_and_grad(bce)(jnp.asarray(pred[case]))
            sil = np.asarray(jax_proj.project_silhouettes(
                jnp.asarray(pred[case]), jnp.asarray(gt[case]), GRID, GRID, SIGMA_SQ,
                squash=squash)[0])
            if not squash:
                assert sil.max() > 1.0
            gap = np.abs(1 - sil - np.float32(1e-8))
            cond = 4 * 2.0 ** -23 * sil.max() / gap[gap >= np.float32(1e-7)].min()
            tol = 1e-4 + cond
            tols.append(tol)
            g = got[f"grad_{case}_{squash}"]
            # The mean's value moves by the same relative rounding, over
            # its cells.
            np.testing.assert_allclose(float(got[f"loss_{case}_{squash}"]), float(value),
                                       rtol=RTOL, atol=cond / sil.size)
            err = np.linalg.norm(g - grad) / np.linalg.norm(grad)
            assert err <= tol, f"case {case}, squash {squash}: {err} > {tol}"
    assert min(tols) <= 1e-2
