"""fenet_torch's metrics against the reference's own goldens
(``tests/goldens/metric_goldens.npz``, written by ``tests/make_goldens.py``
from the original PyTorch oracles), at the bounds
``tests/test_reference_parity.py`` holds fenet to, without fenet: the
chamfer distance, the F-score and the auction EMD at the eval settings.

The converged band (the auction at 3000 iterations within 0.5% above the
optimal matching) is held on the card (``chip_smoke.py``, phase
``analysis``): the plain auction takes ~46 s for one golden element on the
CPU.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from fenet_torch.losses.fscore import fscore
from fenet_torch.ops.chamfer import chamfer_distance
from fenet_torch.ops.emd import earth_mover_distance

GOLDENS = Path(__file__).resolve().parent / "goldens" / "metric_goldens.npz"


@pytest.fixture(scope="module")
def goldens():
    """The goldens and their four pairs of clouds, (4, 1024, 3) each, drawn
    from the recorded seed as ``tests/make_goldens.py`` draws them."""
    data = np.load(GOLDENS)
    rng = np.random.RandomState(int(data["seed"]))
    a = rng.rand(4, 1024, 3).astype(np.float32)
    b = rng.rand(4, 1024, 3).astype(np.float32)
    return data, torch.tensor(a), torch.tensor(b)


def test_chamfer_matches_reference_golden(goldens):
    """Per-sample CD and both directions' means to rtol 1e-5; the first 64
    nearest indices of each direction equal (ties are measure-zero on
    random clouds)."""
    data, a, b = goldens
    d1, d2, i1, i2 = chamfer_distance(a, b)
    np.testing.assert_allclose((d1.mean(1) + d2.mean(1)).numpy(), data["cd_per_sample"],
                               rtol=1e-5)
    np.testing.assert_allclose(d1.mean(1).numpy(), data["dist1_mean"], rtol=1e-5)
    np.testing.assert_allclose(d2.mean(1).numpy(), data["dist2_mean"], rtol=1e-5)
    np.testing.assert_array_equal(i1[:, :64].numpy(), data["idx1_head"].astype(np.int32))
    np.testing.assert_array_equal(i2[:, :64].numpy(), data["idx2_head"].astype(np.int32))


def test_fscore_matches_reference_golden(goldens):
    """The oracle thresholds float64 squared distances, the port float32:
    one borderline point moves a mean by 1/4096 (4 samples x 1024 points),
    so two flips of slack."""
    data, a, b = goldens
    fs, p1, p2 = fscore(a, b)
    atol = 2.5 / 4096
    np.testing.assert_allclose(float(fs), data["fscore"], atol=atol)
    np.testing.assert_allclose(float(p1), data["precision_1"], atol=atol)
    np.testing.assert_allclose(float(p2), data["precision_2"], atol=atol)


def test_emd_within_recorded_optimal_margin(goldens):
    """At the eval settings (eps 0.005, 50 iterations) the forced final
    commit leaves the assignment non-bijective, so the cost may land below
    the bijective optimum: each element within 15% of the optimal mean
    matched distance (scipy's exact assignment on the oracle's matrix)."""
    data, a, b = goldens
    dist, _ = earth_mover_distance(a, b, 0.005, 50)
    at_eval = dist.sqrt().mean(1).double().numpy()
    opt = data["emd_optimal_sqrt_mean"]
    assert (np.abs(at_eval - opt) <= 0.15 * opt).all(), (at_eval, opt)
