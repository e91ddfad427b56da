"""The plain reference against the port (``fenet_torch``) at tiny widths on
the CPU: the weights, the forward in both BatchNorm modes, the deploy fold,
chamfer, the auction, the Sinkhorn potentials, ICP and one Adam step."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.reference import generator as ref  # noqa: E402
from portbench.reference import icp as ref_icp  # noqa: E402
from portbench.reference import losses as ref_losses  # noqa: E402
from portbench.reference.adam import Adam  # noqa: E402
from portbench.reference.precision import Operands  # noqa: E402
from portbench.tests.tiny import TINY_CONFIG  # noqa: E402

CPU = torch.device("cpu")


def port_generator(cfg, state, deploy=False):
    from fenet_torch.models.generator import Generator

    gen = Generator(num_points=cfg["num_points"], backbone=cfg["backbone"],
                    fine_width=cfg["fine_width"], mid_width=cfg["mid_width"], deploy=deploy)
    gen.load_state_dict(state, strict=True)
    return gen


def clouds(seed, b, n, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((b, n, 3), generator=g) * scale, torch.rand((b, n, 3), generator=g) * 0.9


def test_state_loads_into_the_port_and_counts_its_parameters():
    state = ref.init(TINY_CONFIG, 3, CPU)
    gen = port_generator(TINY_CONFIG, state)
    assert ref.parameter_count(TINY_CONFIG) == sum(p.numel() for p in gen.parameters())
    assert list(state) == list(gen.state_dict())


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_port(train):
    state = ref.init(TINY_CONFIG, 5, CPU, head_scale=0.03)
    gen = port_generator(TINY_CONFIG, state).train(train)
    images = torch.randint(0, 256, (3, 128, 128, 3), dtype=torch.uint8)
    with torch.no_grad():
        want = gen(images)
        got = ref.forward(state, images, TINY_CONFIG, train)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def test_fold_matches_the_ports_fold():
    from fenet_torch.models.generator import to_deploy

    state = ref.init(TINY_CONFIG, 7, CPU, head_scale=0.03, random_bn=True)
    gen = port_generator(TINY_CONFIG, state).eval()
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8)
    with torch.no_grad():
        want = to_deploy(gen)(images)[2]
        branched = gen(images)[2]
    got = ref.deploy_forward(ref.fold(state, TINY_CONFIG), images, TINY_CONFIG)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got, branched, rtol=1e-4, atol=1e-5)


def test_chamfer_matches_the_port():
    from fenet_torch.ops.chamfer import chamfer_distance_ref

    a, b = clouds(0, 3, 300)
    d1, d2 = ref_losses.chamfer(a, b)
    w1, w2, _, _ = chamfer_distance_ref(a, b)
    torch.testing.assert_close(d1, w1, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(d2, w2, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("eps,iters,scale", [(0.05, 3000, 3.0), (0.005, 50, 1.0)])
def test_auction_matches_the_ports_plain_auction(eps, iters, scale):
    from fenet_torch.ops.emd import _auction_plain

    a, b = clouds(1, 3, 200, scale)
    got = ref_losses.auction(a, b, eps, iters, rows=2)
    _, want = _auction_plain(a, b, eps, iters)
    assert torch.equal(got, want.long())


def test_sinkhorn_potentials_match_the_port():
    from fenet_torch.ops.sinkhorn import _potentials_plain

    a, b = clouds(2, 2, 150)
    f, g = ref_losses.potentials(a, b, 1e-4, 60, 0.25)
    wf, wg = _potentials_plain(a, b, 1e-4, 60, 0.25)
    torch.testing.assert_close(f, wf, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(g, wg, rtol=1e-4, atol=1e-5)


def test_sinkhorn_loss_matches_the_port():
    from fenet_torch.losses.sinkhorn import sinkhorn_emd_loss

    a, b = clouds(4, 2, 128)
    a.requires_grad_(True)
    got = ref_losses.sinkhorn_loss_sum(a, b, 0.01, 40) / 2
    (ga,) = torch.autograd.grad(got, a)
    a2 = a.detach().clone().requires_grad_(True)
    want = sinkhorn_emd_loss(a2, b, 0.01, 40)
    (wa,) = torch.autograd.grad(want, a2)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(ga, wa, rtol=1e-3, atol=1e-6)


def test_icp_matches_the_port():
    from fenet_torch.geometry.icp import align_pred_to_gt

    g = torch.Generator().manual_seed(3)
    gt = torch.rand((3, 256, 3), generator=g) - 0.5
    angle = 0.3
    rot = torch.tensor([[1.0, 0.0, 0.0], [0.0, torch.cos(torch.tensor(angle)), -torch.sin(
        torch.tensor(angle))], [0.0, torch.sin(torch.tensor(angle)), torch.cos(torch.tensor(angle))]])
    pred = gt @ rot.T + 0.05 + 0.01 * torch.randn((3, 256, 3), generator=g)
    torch.testing.assert_close(ref_icp.align(pred, gt), align_pred_to_gt(pred, gt), rtol=0,
                               atol=0)


def test_adam_step_matches_torch():
    g = torch.Generator().manual_seed(9)
    p0 = {"w": torch.randn(5, 4, generator=g), "b": torch.randn(4, generator=g)}
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in p0.items()} for _ in range(3)]
    mine = {k: v.clone() for k, v in p0.items()}
    adam = Adam(5e-4, 1e-4)
    theirs = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    opt = torch.optim.Adam(theirs.values(), lr=5e-4, weight_decay=1e-4)
    for step in grads:
        adam.step(mine, step)
        for k, v in theirs.items():
            v.grad = step[k].clone()
        opt.step()
    for k in p0:
        torch.testing.assert_close(mine[k], theirs[k].detach(), rtol=1e-6, atol=1e-9)


def test_operands_round_as_the_lower_precisions():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -10), 3.0])
    tf32 = Operands("tf32")(x)
    assert tf32.tolist() == [1.0, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 3.0]
    fp8 = Operands("fp8")(torch.tensor([448.0, 1.0, 0.3]))
    assert fp8[0] == 448.0 and torch.all((fp8 - torch.tensor([448.0, 1.0, 0.3])).abs() < 0.04)
    x = torch.randn(10, requires_grad=True)
    (Operands("tf32")(x) * 2.0).sum().backward()
    assert torch.equal(x.grad, torch.full((10,), 2.0))
