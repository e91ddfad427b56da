"""fenet_torch.losses against fenet.losses: every function of the facade and
of the Sinkhorn module on the same numpy clouds, and the gradients of the
chamfer, auction-EMD (fixed eps and eps-scaling) and Sinkhorn losses against
``jax.grad``.

Torch autograd and XLA:CPU corrupt the heap when both run in one process, so
the torch gradients come from this file run as a script in a subprocess
(``python tests/test_torch_losses.py <in.npz> <out.npz>``), which imports
no JAX.

Tolerances: chamfer and auction losses and their gradients are float32
sums of the same terms in other orders (rtol 1e-5). The Sinkhorn loss
exponentiates (f + g - C)/eps at eps = 1e-4, so a 1e-7 difference in a
potential moves the plan by ~1e-3: fenet on the CPU anneals with
``q ** t`` where the Pallas kernel and the port use ``exp(log_q·t)``.
Measured here: the loss differs by 3.1e-6 relative and its gradient by
1.0e-4 (max abs difference over max abs); held to 1e-4 and 1e-3.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
SINKHORN = dict(blur=0.01, iters=300)
# (eps, iters, scale_phases, early_exit, scale_thresh) of the EMD modes.
AUCTION_MODES = {
    "fixed": (0.05, 300, 1, True, 0.0),
    "scaled": (0.05, 300, 3, True, 0.3),
    "scaled_no_exit": (0.05, 300, 3, False, 0.3),
}


def _clouds(seed, n=256):
    """A clustered prediction against a spread gt, as early in training."""
    rng = np.random.RandomState(seed)
    gt = (rng.rand(2, n, 3) * 0.8 - 0.4).astype(np.float32)
    pred = (rng.randn(2, n, 3) * 0.05 + rng.randn(2, 1, 3) * 0.1).astype(np.float32)
    return pred, gt


def _torch_grads(pred: np.ndarray, gt: np.ndarray):
    """Loss value and d loss / d pred of each loss, by torch autograd."""
    from fenet_torch.losses.facade import chamfer_loss, emd_loss
    from fenet_torch.losses.sinkhorn import sinkhorn_emd_loss

    fns = {"chamfer": chamfer_loss,
           "sinkhorn": lambda p, g: sinkhorn_emd_loss(p, g, **SINKHORN)}
    for name, args in AUCTION_MODES.items():
        fns[f"emd_{name}"] = lambda p, g, a=args: emd_loss(p, g, *a)
    out = {}
    for name, fn in fns.items():
        p = torch.tensor(pred, requires_grad=True)
        loss = fn(p, torch.tensor(gt))
        loss.backward()
        out[name] = loss.detach().numpy()
        out[f"{name}.grad"] = p.grad.numpy()
    return out


if __name__ == "__main__":
    blob = np.load(sys.argv[1])
    np.savez(sys.argv[2], **_torch_grads(blob["pred"], blob["gt"]))
    raise SystemExit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from fenet.losses import facade as jf  # noqa: E402
from fenet.losses import sinkhorn as js  # noqa: E402
from fenet_torch.losses import facade as tf  # noqa: E402
from fenet_torch.losses import sinkhorn as ts  # noqa: E402

RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny tensors in long loops: beside other test workers, torch's OpenMP
    threads oversubscribe the cores and spin (measured 30-50x slower with
    three workers), and one thread is fastest anyway."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SINKHORN_LOSS_RTOL = 1e-4
SINKHORN_GRAD_RTOL = 1e-3


def _both(pred, gt):
    return (jnp.asarray(pred), jnp.asarray(gt)), (torch.tensor(pred), torch.tensor(gt))


def test_emd_constants_match_fenet():
    for name in ("TRAIN_EMD_EPS", "TRAIN_EMD_ITERS", "EVAL_EMD_EPS", "EVAL_EMD_ITERS"):
        assert getattr(tf, name) == getattr(jf, name)


@pytest.mark.parametrize("name", ["chamfer_loss", "point_loss", "emd_loss"])
def test_scalar_losses_match_fenet(name):
    j, t = _both(*_clouds(0))
    want = float(getattr(jf, name)(*j))
    got = float(getattr(tf, name)(*t))
    assert got == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("mode", list(AUCTION_MODES))
def test_emd_loss_modes_match_fenet(mode):
    j, t = _both(*_clouds(1))
    args = AUCTION_MODES[mode]
    assert float(tf.emd_loss(*t, *args)) == pytest.approx(float(jf.emd_loss(*j, *args)), rel=RTOL)


def test_point_loss_test_and_facade_match_fenet():
    j, t = _both(*_clouds(2))
    for got, want in zip(tf.point_loss_test(*t), jf.point_loss_test(*j)):
        assert float(got) == pytest.approx(float(want), rel=RTOL)
    loss_t, loss_j = tf.Loss(radius=1.0), jf.Loss(radius=1.0)
    assert loss_t.radius == loss_j.radius
    assert float(loss_t.get_chamfer_loss(*t)) == pytest.approx(
        float(loss_j.get_chamfer_loss(*j)), rel=RTOL)
    assert float(loss_t.get_emd_loss(*t)) == pytest.approx(float(loss_j.get_emd_loss(*j)), rel=RTOL)


@pytest.mark.parametrize("epoch", [30, 31])
def test_scheduled_total_loss_matches_fenet(epoch):
    j, t = _both(*_clouds(3))
    total_j, parts_j = jf.scheduled_total_loss(*j, epoch, emd_iters=300)
    total_t, parts_t = tf.scheduled_total_loss(*t, epoch, emd_iters=300)
    assert float(total_t) == pytest.approx(float(total_j), rel=RTOL)
    for key in ("chamfer_loss", "emd_loss"):
        assert float(parts_t[key]) == pytest.approx(float(parts_j[key]), rel=RTOL)
    emd_only = 100.0 * float(parts_t["emd_loss"])
    assert (float(total_t) == pytest.approx(emd_only)) == (epoch > 30)


def test_sinkhorn_distance_and_batch_loss_match_fenet():
    rng = np.random.RandomState(4)
    x, y = rng.rand(2, 64, 3).astype(np.float32), rng.rand(2, 48, 3).astype(np.float32)
    (xj, yj), (xt, yt) = _both(x, y)
    np.testing.assert_allclose(ts.sinkhorn_distance(xt, yt, 0.1, 50).numpy(),
                               np.asarray(js.sinkhorn_distance(xj, yj, 0.1, 50)), rtol=1e-4)
    assert float(ts.batch_emd_loss(xt, yt, 0.1, 50)) == pytest.approx(
        float(js.batch_emd_loss(xj, yj, 0.1, 50)), rel=1e-4)


def test_sinkhorn_emd_loss_matches_fenet():
    j, t = _both(*_clouds(5))
    want = float(js.sinkhorn_emd_loss(*j, **SINKHORN))
    got = float(ts.sinkhorn_emd_loss(*t, **SINKHORN))
    assert got == pytest.approx(want, rel=SINKHORN_LOSS_RTOL)
    # eps0 below the target eps is raised to it, as in fenet.
    want = float(js.sinkhorn_emd_loss(*j, blur=0.6, iters=30, eps0=0.25))
    got = float(ts.sinkhorn_emd_loss(*t, blur=0.6, iters=30, eps0=0.25))
    assert got == pytest.approx(want, rel=SINKHORN_LOSS_RTOL)


def test_loss_gradients_match_jax_grad(tmp_path):
    pred, gt = _clouds(6)
    np.savez(tmp_path / "in.npz", pred=pred, gt=gt)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, __file__, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, cwd=REPO, env=env, timeout=300)
    got = np.load(tmp_path / "out.npz")
    jfns = {"chamfer": jf.chamfer_loss,
            "sinkhorn": lambda p, g: js.sinkhorn_emd_loss(p, g, **SINKHORN)}
    for name, args in AUCTION_MODES.items():
        jfns[f"emd_{name}"] = lambda p, g, a=args: jf.emd_loss(p, g, *a)
    for name, fn in jfns.items():
        value, grad = jax.value_and_grad(fn)(jnp.asarray(pred), jnp.asarray(gt))
        grad = np.asarray(grad)
        if name == "sinkhorn":
            assert float(got[name]) == pytest.approx(float(value), rel=SINKHORN_LOSS_RTOL)
            scale = np.abs(grad).max()
            assert np.abs(got[f"{name}.grad"] - grad).max() <= SINKHORN_GRAD_RTOL * scale, name
        else:
            assert float(got[name]) == pytest.approx(float(value), rel=RTOL), name
            np.testing.assert_allclose(got[f"{name}.grad"], grad, rtol=RTOL,
                                       atol=RTOL * np.abs(grad).max(), err_msg=name)
