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

The Sinkhorn loss's fused plan (``fenet_torch.ops.sinkhorn.plan_cost``,
``csrc/sinkhorn_plan.cu``) runs only on a card. Here its sums and its
backward formula are held, in a rendering in torch, against autograd
through ``plan_loss`` (in the subprocess, in float64: the formulas, not the
kernel's float32 rounding, are what the CPU can check). Tests marked
``gpu`` hold the kernel against ``pairwise_sqdist`` + ``plan_loss`` on the
card, which has no JAX: ``python -m pytest --noconftest -m gpu
tests/test_torch_losses.py``.
"""

import math
import os
import subprocess
import sys
import tempfile
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


def _plan_sums(x, y, f, g, eps):
    """``csrc/sinkhorn_plan.cu``'s sums in torch, over (B, N, M) tensors:
    per pair the cost d (unclamped, as ``pairwise_sqdist`` computes it) and
    c = max(d, 0), pi from c as ``plan_loss`` takes it, and the clamp's mask
    d >= 0; per row the cost N·sum_j pi·c and V = sum_j pi·[d >= 0]·(x_i -
    y_j). Returns (cost, V, pi·mask, x_i - y_j)."""
    from fenet_torch.ops.pairwise import sqnorm

    n, m = x.shape[1], y.shape[1]
    d = (sqnorm(x)[:, :, None] + sqnorm(y)[:, None, :]) - 2.0 * torch.matmul(x, y.transpose(1, 2))
    c = d.clamp_min(0.0)
    pi = torch.exp((f[:, :, None] + g[:, None, :] - c) / eps - math.log(n) - math.log(m))
    live = pi * (d >= 0)
    diff = x[:, :, None, :] - y[:, None, :, :]
    return n * torch.sum(pi * c, dim=2), (live[..., None] * diff).sum(dim=2), live, diff


def _plan_columns(x, y, f, g, u, eps):
    """The column kernel's sums: W_j = sum_i u_i·pi_ij·[d_ij >= 0]·(x_i - y_j)."""
    _, _, live, diff = _plan_sums(x, y, f, g, eps)
    return ((u[:, :, None] * live)[..., None] * diff).sum(dim=1)


def _plan_rendering(x, y, f, g, eps, tail):
    """The kernels' sums and the backward formula, with u the gradient of
    ``tail`` at the per-point costs: x's gradient 2N·u·V, y's -2N·W (the
    column pass). Returns (tail's value, per-point cost, grad x, grad y)."""
    n = x.shape[1]
    cost, v, _, _ = _plan_sums(x, y, f, g, eps)
    leaf = cost.clone().requires_grad_(True)
    value = tail(leaf)
    (u,) = torch.autograd.grad(value, leaf)
    return (value.detach(), cost, 2 * n * u[..., None] * v,
            -2 * n * _plan_columns(x, y, f, g, u, eps))


def _plan_cases():
    """Each PLAN_CASES case in float64: the rendering's numbers, autograd's
    through ``plan_loss`` (on ``pairwise_sqdist``, x and y leaves), and the
    fused op's autograd Function (``plan_cost``) with its two kernels
    swapped for the rendering's sums; the tail swapped where the case asks."""
    from fenet_torch.losses import sinkhorn as ts
    from fenet_torch.ops import sinkhorn as ops
    from fenet_torch.ops.pairwise import pairwise_sqdist

    torch.set_num_threads(1)
    ops.plan_kernel = lambda x, y, f, g, eps: _plan_sums(x, y, f, g, eps)[:2]
    ops.plan_columns_kernel = _plan_columns
    out = {}
    for name, (x, y, weights) in PLAN_CASES.items():
        eps = SINKHORN["blur"] ** 2
        f, g = ts.sinkhorn_potentials(torch.tensor(x), torch.tensor(y), eps, SINKHORN["iters"])
        x, y, f, g = (torch.tensor(np.asarray(a), dtype=torch.float64) for a in (x, y, f, g))
        tail = ts.mean_root if weights is None else (
            lambda cost, w=torch.tensor(weights, dtype=torch.float64): (cost * w).sum())
        value, cost, grad_x, grad_y = _plan_rendering(x, y, f, g, eps, tail)
        results = {"value": value, "cost": cost, "grad_x": grad_x, "grad_y": grad_y}
        for path in ("auto", "op"):
            xl, yl = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
            if path == "op":
                loss = tail(ops.plan_cost(xl, yl, f, g, eps))
            else:
                mean_root = ts.mean_root
                ts.mean_root = tail  # plan_loss's tail, looked up as the module's global
                try:
                    c = pairwise_sqdist(xl, yl)
                    loss = ts.plan_loss(c.detach(), c, f, g, eps)
                finally:
                    ts.mean_root = mean_root
            loss.backward()
            results.update({f"{path}_loss": loss.detach(), f"{path}_x": xl.grad,
                            f"{path}_y": yl.grad})
        for key, val in results.items():
            out[f"{name}.{key}"] = val.numpy()
    return out


def _plan_clouds():
    """PLAN_CASES: {name: (x, y, per-point weights or None)}. "sqrt": the
    loss's own tail on a clustered prediction against a spread gt, N != M.
    "zero_rows": gt on a grid 0.35 apart; the first element's prediction
    the grid's points in another order, the second's points off the grid;
    under a weighted sum of the per-point costs (at a zero cost the square
    root's gradient is infinite): the first element's plan pairs each point
    with its copy, its rows cost ~0 and their pairs sit on the clamp's
    boundary."""
    rng = np.random.RandomState(8)
    gt = (rng.rand(2, 48, 3) * 0.8 - 0.4).astype(np.float32)
    pred = (rng.randn(2, 64, 3) * 0.05 + rng.randn(2, 1, 3) * 0.1).astype(np.float32)
    grid = np.stack(np.meshgrid(*(np.arange(k) * 0.35 for k in (4, 4, 3)), indexing="ij"), -1)
    grid = np.broadcast_to(grid.reshape(1, 48, 3), (2, 48, 3)).astype(np.float32)
    copies = np.stack([grid[0, rng.permutation(48)], (rng.rand(48, 3) * 1.05)])
    return {"sqrt": (pred, gt, None),
            "zero_rows": (copies.astype(np.float32), grid, rng.rand(2, 48) + 0.5)}


PLAN_CASES = _plan_clouds()


if __name__ == "__main__":
    if sys.argv[1] == "plan":
        np.savez(sys.argv[2], **_plan_cases())
    else:
        blob = np.load(sys.argv[1])
        np.savez(sys.argv[2], **_torch_grads(blob["pred"], blob["gt"]))
    raise SystemExit(0)

import pytest  # noqa: E402

try:
    import jax

    import jax.numpy as jnp

    from fenet.losses import facade as jf
    from fenet.losses import sinkhorn as js
except ImportError:
    # The card machine has no JAX; there only the gpu tests run, with
    # `pytest --noconftest -m gpu` (tests/conftest.py imports JAX).
    pass
from fenet_torch.losses import facade as tf  # noqa: E402
from fenet_torch.losses import sinkhorn as ts  # noqa: E402
from fenet_torch.ops import sinkhorn as ops_sinkhorn  # noqa: E402
from fenet_torch.ops.pairwise import pairwise_sqdist  # noqa: E402

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


# The fused plan: its sums and backward against autograd (CPU, float64, in
# the subprocess) and the loss's routing; on the card, the kernel.
PLAN_RTOL = 1e-6


@pytest.fixture(scope="module")
def plan_cases():
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "plan.npz"
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
        subprocess.run([sys.executable, __file__, "plan", str(out)], check=True, cwd=REPO,
                       env=env, timeout=300)
        return dict(np.load(out))


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plan_row_sums_match_autograd(plan_cases, case):
    """The kernel's row sums (cost, V), its backward formula for x and its
    column pass for y, rendered in torch, and the fused op's autograd
    Function over those sums, equal autograd through ``plan_loss`` to 1e-6
    of the largest element."""
    got = {k.split(".", 1)[1]: v for k, v in plan_cases.items() if k.startswith(f"{case}.")}
    for value in ("value", "op_loss"):
        assert float(got[value]) == pytest.approx(float(got["auto_loss"]), rel=PLAN_RTOL)
    for mine, auto in (("grad_x", "auto_x"), ("grad_y", "auto_y"), ("op_x", "auto_x"),
                       ("op_y", "auto_y")):
        scale = np.abs(got[auto]).max()
        assert scale > 0 and np.isfinite(got[mine]).all()
        assert np.abs(got[mine] - got[auto]).max() <= PLAN_RTOL * scale, mine
    if case == "zero_rows":  # the copies cost nothing, the others do
        assert np.abs(got["cost"][0]).max() <= 1e-12 < 1e-3 < got["cost"][1].max()


def test_plan_on_cpu_tensors_takes_the_plain_path():
    """CPU tensors take pairwise_sqdist + plan_loss: the same bits, and no
    count of the plan kernels moves."""
    x, y = (torch.tensor(a) for a in _clouds(9, n=128))
    before = (ops_sinkhorn.plan_kernel.launches, ops_sinkhorn.plan_columns_kernel.launches)
    got = ts.sinkhorn_emd_loss(x, y, blur=0.05, iters=50)
    f, g = ops_sinkhorn.sinkhorn_potentials(x, y, 0.05 ** 2, 50)
    c = pairwise_sqdist(x, y)
    assert torch.equal(got, ts.plan_loss(c, c, f, g, 0.05 ** 2))
    assert (ops_sinkhorn.plan_kernel.launches,
            ops_sinkhorn.plan_columns_kernel.launches) == before


def test_sinkhorn_loss_looks_up_the_potentials_by_module_global(monkeypatch):
    """The loss calls ``sinkhorn_potentials`` through its module's global,
    so a span wrapped around that name (as portbench's traced runs wrap it)
    holds the potentials, and the plan's span runs after it, outside it."""
    calls = []
    real = ts.sinkhorn_potentials

    def wrapped(*args, **kwargs):
        calls.append(args[2:])
        with torch.profiler.record_function("outer.potentials"):
            return real(*args, **kwargs)

    monkeypatch.setattr(ts, "sinkhorn_potentials", wrapped)
    x, y = (torch.tensor(a) for a in _clouds(10, n=64))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ts.sinkhorn_emd_loss(x, y, blur=0.05, iters=20)
    assert calls == [(0.05 ** 2, 20, 0.25)]
    spans = {}
    for e in prof.events():
        if e.name in ("outer.potentials", "fenet_torch.ops.potentials",
                      "fenet_torch.sinkhorn.plan"):
            parents, parent = [], e.cpu_parent
            while parent is not None:
                parents.append(parent.name)
                parent = parent.cpu_parent
            spans[e.name] = (e.time_range.start, e.time_range.end, parents)
    assert "outer.potentials" in spans["fenet_torch.ops.potentials"][2]
    assert "outer.potentials" not in spans["fenet_torch.sinkhorn.plan"][2]
    assert spans["outer.potentials"][1] <= spans["fenet_torch.sinkhorn.plan"][0]


# The card: the fused op against pairwise_sqdist + plan_loss, on K7's (or,
# above its 8192 points, the plain version's) potentials.
PLAN_LOSS_RTOL = 1e-5
PLAN_GRAD_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _plan_on_card(x, y, iters, gt_grad):
    """The Sinkhorn EMD loss on the card, fused and plain, from the same
    potentials: {"fused"/"plain": (loss, grad x, grad y or None)}, the
    launches of each plan kernel in the fused call, and the fused call's
    peak memory above what was allocated before it."""
    eps = SINKHORN["blur"] ** 2
    f, g = ops_sinkhorn.sinkhorn_potentials(x, y, eps, iters)
    out = {}
    for path in ("fused", "plain"):
        xl = x.clone().requires_grad_(True)
        yl = y.clone().requires_grad_(gt_grad)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = (ops_sinkhorn.plan_kernel.launches, ops_sinkhorn.plan_columns_kernel.launches)
        if path == "fused":
            loss = ts.mean_root(ops_sinkhorn.plan_cost(xl, yl, f, g, eps))
        else:
            c = pairwise_sqdist(xl, yl)
            loss = ts.plan_loss(c.detach(), c, f, g, eps)
        loss.backward()
        torch.cuda.synchronize()
        if path == "fused":
            out["launches"] = (ops_sinkhorn.plan_kernel.launches - before[0],
                               ops_sinkhorn.plan_columns_kernel.launches - before[1])
            out["peak"] = torch.cuda.max_memory_allocated() - base
        out[path] = (float(loss.detach()), xl.grad, yl.grad)
    return out


def _assert_plan_close(out, gt_grad):
    (loss_k, gx_k, gy_k), (loss_p, gx_p, gy_p) = out["fused"], out["plain"]
    assert loss_k == pytest.approx(loss_p, rel=PLAN_LOSS_RTOL)
    pairs = [(gx_k, gx_p)] + ([(gy_k, gy_p)] if gt_grad else [])
    for got, want in pairs:
        scale = float(want.abs().max())
        assert scale > 0 and float((got - want).abs().max()) <= PLAN_GRAD_RTOL * scale
    assert out["launches"] == (1, int(gt_grad))


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,m,iters", [
    (128, 2048, 2048, 300),  # the train shape, K7's potentials
    (4, 2048, 1536, 100),  # N != M
    (3, 1000, 700, 100),  # N and M not multiples of a block's 512 rows or a 256-point tile
    (2, 8448, 8448, 3),  # above K7's 8192 points: the potentials' plain version
])
def test_plan_kernel_matches_plain_on_card(cuda, b, n, m, iters):
    """The fused plan against pairwise_sqdist + plan_loss: the loss to 1e-5
    relative, x's gradient to 1e-4 of its largest element, one row launch a
    call and no column launch, and no tensor of B·N·M floats allocated."""
    rng = np.random.RandomState(23)
    x = torch.tensor((rng.rand(b, n, 3) * 0.9).astype(np.float32), device=cuda)
    y = torch.tensor((rng.rand(b, m, 3) * 0.9).astype(np.float32), device=cuda)
    out = _plan_on_card(x, y, iters, gt_grad=False)
    _assert_plan_close(out, gt_grad=False)
    assert out["peak"] < b * n * m * 4, out["peak"]


@pytest.mark.gpu
@pytest.mark.parametrize("gt_grad", [False, True])
def test_plan_kernel_coincident_points_on_card(cuda, monkeypatch, gt_grad):
    """A quarter of the predicted points on gt points exactly, on dyadic
    coordinates (k/64: every cost exact on both paths): those pairs cost 0,
    the clamp's boundary, where its mask passes the gradient, and some rows
    cost 0, where the square root's gradient is infinite on both paths: the
    per-point costs are held under a weighted sum in place of the loss's
    tail. With gt requiring a gradient the column pass runs, once."""
    rng = np.random.RandomState(24)
    y = rng.randint(0, 58, size=(4, 1024, 3)) / 64.0
    x = rng.randint(0, 58, size=(4, 1024, 3)) / 64.0
    x[:, :256] = y[:, rng.permutation(1024)[:256]]
    x, y = (torch.tensor(a.astype(np.float32), device=cuda) for a in (x, y))
    d = pairwise_sqdist(x, y)
    assert int((d == 0).sum()) >= 4 * 256
    weights = torch.tensor(rng.rand(4, 1024).astype(np.float32) + 0.5, device=cuda)
    monkeypatch.setattr(ts, "mean_root", lambda cost: (cost * weights).sum())
    out = _plan_on_card(x, y, 100, gt_grad)
    _assert_plan_close(out, gt_grad)
