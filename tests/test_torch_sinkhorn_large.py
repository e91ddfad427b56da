"""The Sinkhorn loss above the kernel's 8192 points.

fenet takes its Pallas kernels only at the shapes they fit and runs its XLA
loop everywhere else (``fenet/losses/sinkhorn.py:112-158``). The port's
``sinkhorn_potentials`` does the same by shape, before any launch: above
``MAX_N`` points it runs the plain version on the tensors' own device, so
``--emd_impl sinkhorn --num_points 8448`` (33·256, the first generator size
above 8192) trains on the card. ``potentials_kernel`` itself still raises
there (``tests/test_torch_ops.py``).

Tests marked ``gpu`` skip without a card; on the card, which has no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_sinkhorn_large.py``.
"""

import numpy as np
import pytest
import torch

from fenet_torch.ops import sinkhorn
from fenet_torch.ops.sinkhorn import MAX_N, _potentials_plain, sinkhorn_potentials

N_LARGE = 8448
RTOL, ATOL = 1e-4, 1e-5  # fenet's tolerance on the potentials


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,m,kernel", [(MAX_N, MAX_N, True), (MAX_N + 1, 8, False),
                                        (8, MAX_N + 1, False), (N_LARGE, N_LARGE, False)])
def test_route_is_chosen_by_shape(n, m, kernel, monkeypatch):
    """On a device other than the CPU (``meta`` here, shapes only) the
    wrapper calls the kernel up to MAX_N points a cloud and the plain
    version above, without calling the kernel."""
    calls = []

    def launch(x, y, *args):
        calls.append((x.shape, y.shape))
        return x[..., 0], y[..., 0]

    monkeypatch.setattr(sinkhorn, "potentials_kernel", launch)
    x = torch.empty((2, n, 3), device="meta")
    y = torch.empty((2, m, 3), device="meta")
    f, g = sinkhorn_potentials(x, y, 1e-4, 3)
    assert f.shape == (2, n) and g.shape == (2, m) and f.device.type == "meta"
    assert calls == ([((2, n, 3), (2, m, 3))] if kernel else [])


@pytest.mark.gpu
def test_potentials_above_max_n_on_card(cuda):
    """(2, 8448) clouds, 3 iterations: the plain version on the card equals
    it on the CPU, and no kernel launches."""
    rng = np.random.RandomState(23)
    x_host = torch.tensor(rng.rand(2, N_LARGE, 3).astype(np.float32))
    y_host = torch.tensor(rng.rand(2, N_LARGE, 3).astype(np.float32))
    before = sinkhorn.potentials_kernel.launches
    f, g = sinkhorn_potentials(x_host.to(cuda), y_host.to(cuda), 1e-4, 3)
    torch.cuda.synchronize()
    assert sinkhorn.potentials_kernel.launches == before
    f_p, g_p = _potentials_plain(x_host, y_host, 1e-4, 3, 0.25)
    torch.testing.assert_close(f.cpu(), f_p, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(g.cpu(), g_p, rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
def test_sinkhorn_train_step_above_max_n_on_card(cuda):
    """One Trainer(emd_impl="sinkhorn") step at 8448 points, batch 2: finite
    losses, no K6/K7 launch."""
    from fenet_torch.models.generator import Generator, init_random_
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer

    small = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
    gen = init_random_(Generator(num_points=N_LARGE, **small), torch.Generator().manual_seed(0))
    trainer = Trainer(gen, TrainConfig(batch_size=2, num_points=N_LARGE, emd_impl="sinkhorn",
                                       **small), device=cuda)
    rng = np.random.RandomState(24)
    images = (rng.rand(2, 128, 128, 3) * 255).astype(np.float32)
    points = (rng.rand(2, N_LARGE, 3) * 0.9).astype(np.float32)
    before = sinkhorn.potentials_kernel.launches
    stats = trainer.train_step(images, points, 1, 5e-4)
    losses = {k: float(v) for k, v in stats.items()}
    assert sinkhorn.potentials_kernel.launches == before
    assert all(np.isfinite(v) for v in losses.values()), losses
