"""The port's Adam (``fenet_torch.ops.adam``): torch's ``Adam`` whose step on
the card is one hand-written CUDA pass.

On the CPU: the class's step (torch's own there) against
``torch.optim.Adam`` bit for bit; the plain version against torch's
single-tensor Adam; ``state_dict`` and loads both ways; ``make_optimizer``;
a trainer's state through fenet's flax and orbax containers; the wrapper's
checks. On the card (``gpu``): the kernel against the plain version and
``torch.optim.Adam(foreach=True)``, and one ``Trainer.train_step``'s
launches, elements and host syncs.

Tolerances. On the CPU the plain version runs the single-tensor path's
float32 operations in its order, so it is held to it bit for bit. On the
card the kernel follows the foreach path's order with IEEE rounding, a
product that feeds a sum fused as nvcc fuses torch's functors: the moments
to 1 ulp and the parameters to 4 ulp of their tensor's largest after three
steps, since where torch's build contracts an expression otherwise an
element rounds once differently, and a parameter's update divides by both
moments. The plain version on the card divides
by the bias correction as a product with its reciprocal (torch's division
of a tensor by a Python scalar there), which moves the denominator by up to
1 ulp: it is held to the same bounds.

Nothing here decides at import time whether there is a card; the ``cuda``
fixture does. The file imports no JAX, and no test runs autograd.
"""

import copy
import math

import pytest
import torch

from fenet_torch.models.generator import Generator
from fenet_torch.ops import adam as adam_mod
from fenet_torch.ops.adam import MAX_TENSORS, Adam, adam_kernel, adam_plain
from fenet_torch.train import checkpoint
from fenet_torch.train.config import TrainConfig
from fenet_torch.train.trainer import Trainer, make_optimizer
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

LR, WD = 5e-4, 1e-4
HYPER = dict(lr=LR, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=WD)
SMALL = dict(num_points=256, backbone="RepVGG-TEST", fine_width=32, mid_width=16)
# Sizes of the card's comparison: single elements, odd tails, one float4
# chunk and a tail, and one above 2^24 elements.
CARD_SIZES = (1, 3, 5, 4097, 2 ** 24 + 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _params(shapes, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(device) for s in shapes]


def _set_grads(groups, step, seed=1, skip=-1):
    """The same seeded gradient on the k-th parameter of every list in
    ``groups``; parameter ``skip`` gets none."""
    gen = torch.Generator().manual_seed(seed + step)
    for k, params in enumerate(zip(*groups)):
        grad = torch.randn(params[0].shape, generator=gen).to(params[0].device)
        for p in params:
            p.grad = None if k == skip else grad.clone()


def test_cpu_step_equals_torch_adam_bit_for_bit():
    """Five steps, a new LR each, weight decay, one parameter without a
    gradient: the CPU path is torch's own step."""
    shapes = [(1,), (3,), (5,), (4097,), (7, 3), (2, 3, 3, 3)]
    init = _params(shapes)
    ours = [p.clone().requires_grad_() for p in init]
    theirs = [p.clone().requires_grad_() for p in init]
    opt, ref = Adam(ours, lr=LR, weight_decay=WD), torch.optim.Adam(theirs, lr=LR, weight_decay=WD)
    for step in range(5):
        _set_grads([ours, theirs], step, skip=2)
        for o in (opt, ref):
            for group in o.param_groups:
                group["lr"] = LR * (step + 1)
            o.step()
    for a, b in zip(ours, theirs):
        assert torch.equal(a, b)
    for a, b in zip(ours, theirs):
        sa, sb = opt.state[a], ref.state[b]
        assert sa.keys() == sb.keys()
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
    assert not opt.state[ours[2]]  # no gradient, no state, as torch


def test_plain_matches_torch_single_tensor_adam():
    """Three steps of the plain version against ``torch.optim.Adam(foreach=
    False)``: bit for bit (the same float32 operations in the same order)."""
    shapes = [(1,), (3,), (5,), (4097,), (64, 33)]
    init = _params(shapes)
    plain = [p.clone() for p in init]
    theirs = [p.clone().requires_grad_() for p in init]
    ref = torch.optim.Adam(theirs, lr=LR, weight_decay=WD, foreach=False)
    m = [torch.zeros_like(p) for p in plain]
    v = [torch.zeros_like(p) for p in plain]
    for step in range(3):
        _set_grads([theirs], step)
        ref.step()
        adam_plain(plain, [p.grad for p in theirs], m, v, [step + 1.0] * len(plain), **HYPER)
    for k, (a, b) in enumerate(zip(plain, theirs)):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)
        torch.testing.assert_close(m[k], ref.state[b]["exp_avg"], rtol=0, atol=0)
        torch.testing.assert_close(v[k], ref.state[b]["exp_avg_sq"], rtol=0, atol=0)


def _stepped(cls, init, steps=2):
    params = [p.clone().requires_grad_() for p in init]
    opt = cls(params, lr=LR, weight_decay=WD)
    for step in range(steps):
        _set_grads([params], step)
        opt.step()
    return params, opt


def test_state_dict_is_torch_adams():
    """The same keys, dtypes and devices as torch's; torch's state loads into
    the class, and the class's into torch's, unchanged."""
    init = _params([(4,), (3, 5)])
    _, ours = _stepped(Adam, init)
    _, theirs = _stepped(torch.optim.Adam, init)
    a, b = ours.state_dict(), theirs.state_dict()
    assert a["param_groups"] == b["param_groups"]
    assert a["state"].keys() == b["state"].keys()
    for idx in a["state"]:
        assert a["state"][idx].keys() == b["state"][idx].keys() == {"step", "exp_avg",
                                                                    "exp_avg_sq"}
        for key, value in a["state"][idx].items():
            other = b["state"][idx][key]
            assert (value.dtype, value.device, value.shape) == (other.dtype, other.device,
                                                                other.shape)
            assert torch.equal(value, other), key
    assert a["state"][0]["step"].dtype == torch.float32
    assert a["state"][0]["step"].device.type == "cpu"
    params = [p.clone().requires_grad_() for p in init]
    loaded = Adam(params, lr=LR, weight_decay=WD)
    loaded.load_state_dict(b)
    back = torch.optim.Adam([p.clone().requires_grad_() for p in init], lr=LR, weight_decay=WD)
    back.load_state_dict(loaded.state_dict())
    for sd in (loaded.state_dict(), back.state_dict()):
        assert sd["param_groups"] == b["param_groups"]
        for idx, entry in b["state"].items():
            for key, value in entry.items():
                assert torch.equal(sd["state"][idx][key], value)


def test_make_optimizer_returns_the_pass():
    model = torch.nn.Linear(3, 2)
    cfg = TrainConfig()
    opt = make_optimizer(model, cfg)
    assert type(opt) is Adam and isinstance(opt, torch.optim.Adam)
    ref = torch.optim.Adam(model.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=cfg.weight_decay)
    assert opt.state_dict()["param_groups"] == ref.state_dict()["param_groups"]


@pytest.mark.parametrize("fmt", ["flax", "orbax"])
def test_trainer_state_round_trips_through_fenet_containers(fmt, tmp_path):
    """A trainer's model and Adam state after two optimizer steps, written in
    fenet's container and loaded into a fresh trainer: the same tensors,
    torch Adam's layout (a CPU float32 step), and a further step of both
    ends equal."""
    torch.manual_seed(0)
    cfg = TrainConfig(batch_size=2, **SMALL)
    trainer = Trainer(Generator(**SMALL), cfg, device="cpu")
    params = list(trainer.model.parameters())
    for step in range(2):
        _set_grads([params], step)
        trainer.optimizer.step()
    state_dict, optimizer = trainer.full_state()
    path = checkpoint.save_checkpoint({"state_dict": state_dict, "optimizer": optimizer,
                                       "epoch": 1}, False, "cat", str(tmp_path), 1, fmt=fmt)
    blob = checkpoint.load_checkpoint(path)
    fresh = Trainer(Generator(**SMALL), cfg, device="cpu")
    fresh.load_full_state(blob["state_dict"], blob["optimizer"])
    assert type(fresh.optimizer) is Adam
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    mine, theirs = trainer.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert mine["param_groups"] == theirs["param_groups"]
    assert mine["state"].keys() == theirs["state"].keys()
    for idx, entry in mine["state"].items():
        for key, value in entry.items():
            other = theirs["state"][idx][key]
            assert (other.dtype, other.device.type) == (value.dtype, value.device.type)
            assert torch.equal(other, value), (idx, key)
    both = [params, list(fresh.model.parameters())]
    _set_grads(both, 2)
    trainer.optimizer.step()
    fresh.optimizer.step()
    for a, b in zip(*both):
        assert torch.equal(a, b)


def test_kernel_wrapper_rejects_cpu_tensors():
    """The wrapper raises on tensors off the card before any build or
    launch; nothing is counted."""
    p = torch.zeros(4)
    before = adam_kernel.launches
    with pytest.raises(ValueError, match="not a CUDA device"):
        adam_kernel([p], [p], [p], [p], [1.0], **HYPER)
    assert adam_kernel.launches == before


def test_corrections_are_torchs():
    """(-lr/bc1, √bc2) as torch's foreach Adam computes them, in double."""
    neg_step, bc2_sqrt = adam_mod.corrections(3.0, LR, 0.9, 0.999)
    assert neg_step == (LR / (1 - 0.9 ** 3.0)) * -1
    assert bc2_sqrt == (1 - 0.999 ** 3.0) ** 0.5


# ---------------------------------------------------------------- the card


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise |a - b| in units of the last place of the larger."""
    big = torch.maximum(a.abs(), b.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    return (a - b).abs() / (torch.finfo(torch.float32).eps * 2.0 ** torch.floor(torch.log2(big)))


def _assert_within(got, want, ulps: float, what: str):
    gap = float(_ulps(got, want).max())
    assert gap <= ulps, f"{what}: {gap} ulp apart, limit {ulps}"


@pytest.mark.gpu
def test_kernel_matches_plain_and_foreach_on_card(cuda):
    """Three steps over many tensors of odd sizes, one of them a view that
    is not 16-byte aligned (the scalar path): the kernel against the plain
    version and against torch's foreach Adam, on the card."""
    init = _params(CARD_SIZES, cuda)
    base = torch.randn(4098, device=cuda)
    init.append(base[1:])  # 4 bytes past a 16-byte boundary
    kern = [p.clone() for p in init[:-1]] + [base.clone()[1:]]
    plain = [p.clone() for p in init]
    theirs = [p.clone().requires_grad_() for p in init]
    ref = torch.optim.Adam(theirs, lr=LR, weight_decay=WD, foreach=True)
    mk, vk = [torch.zeros_like(p) for p in kern], [torch.zeros_like(p) for p in kern]
    mp, vp = [torch.zeros_like(p) for p in plain], [torch.zeros_like(p) for p in plain]
    for step in range(3):
        _set_grads([theirs], step)
        grads = [p.grad for p in theirs]
        ref.step()
        before = adam_kernel.launches
        adam_kernel(kern, grads, mk, vk, [step + 1.0] * len(kern), **HYPER)
        assert adam_kernel.launches == before + math.ceil(len(kern) / MAX_TENSORS)
        adam_plain(plain, grads, mp, vp, [step + 1.0] * len(plain), **HYPER)
    torch.cuda.synchronize()
    for k, size in enumerate(CARD_SIZES + (4097,)):
        state = ref.state[theirs[k]]
        for label, want_p, want_m, want_v in (("foreach", theirs[k].detach(), state["exp_avg"],
                                               state["exp_avg_sq"]),
                                              ("plain", plain[k], mp[k], vp[k])):
            _assert_within(mk[k], want_m, 1, f"exp_avg of size {size} against {label}")
            _assert_within(vk[k], want_v, 1, f"exp_avg_sq of size {size} against {label}")
            gap = (kern[k] - want_p).abs().max() / want_p.abs().max()
            assert gap <= 4 * torch.finfo(torch.float32).eps, \
                f"param of size {size} against {label}: {float(gap)} of its largest"


@pytest.mark.gpu
def test_step_follows_new_storage_and_loaded_state_on_card(cuda):
    """The class against torch's foreach Adam over five steps on the card,
    with a parameter moved to new storage after step 2 and the state saved
    and loaded back after step 3: each step launches over the tensors as
    they are then."""
    init = _params([(5,), (4097,), (64, 33)], cuda)
    ours = [p.clone().requires_grad_() for p in init]
    theirs = [p.clone().requires_grad_() for p in init]
    opt = Adam(ours, lr=LR, weight_decay=WD)
    ref = torch.optim.Adam(theirs, lr=LR, weight_decay=WD, foreach=True)
    for step in range(5):
        if step == 2:
            ours[1].data = ours[1].data.clone()
        if step == 3:
            opt.load_state_dict(copy.deepcopy(opt.state_dict()))  # new moment tensors
        _set_grads([ours, theirs], step)
        opt.step()
        ref.step()
    torch.cuda.synchronize()
    for a, b in zip(ours, theirs):
        _assert_within(opt.state[a]["exp_avg"], ref.state[b]["exp_avg"], 1, "exp_avg")
        _assert_within(opt.state[a]["exp_avg_sq"], ref.state[b]["exp_avg_sq"], 1, "exp_avg_sq")
        gap = (a.detach() - b.detach()).abs().max() / b.detach().abs().max()
        assert gap <= 4 * torch.finfo(torch.float32).eps
        assert torch.equal(opt.state[a]["step"], ref.state[b]["step"])


@pytest.mark.gpu
def test_wrapper_and_step_reject_what_the_pass_does_not_take_on_card(cuda):
    p = torch.zeros(8, device=cuda)
    for bad, match in ((p.double(), "float64"), (torch.zeros(8, 2, device=cuda)[:, 0],
                                                  "not contiguous"),
                       (torch.zeros(9, device=cuda), "8 elements")):
        with pytest.raises(ValueError, match=match):
            adam_kernel([p], [bad], [p], [p], [1.0], **HYPER)
    param = torch.zeros(8, device=cuda, requires_grad=True)
    param.grad = torch.ones(8, device=cuda)
    opt = Adam([param], lr=LR)
    opt.step()
    param.grad = torch.ones(8, 2, device=cuda)[:, 0]  # the param's size, a stride of 2
    with pytest.raises(ValueError, match="not contiguous"):
        opt.step()
    assert float(opt.state[param]["step"]) == 1.0  # a refused step counts nothing
    param.grad = torch.ones(8, device=cuda)
    with pytest.raises(ValueError, match="amsgrad"):
        Adam([param], lr=LR, amsgrad=True).step()
    cpu = torch.zeros(2, requires_grad=True)
    cpu.grad = torch.ones(2)
    with pytest.raises(ValueError, match="card only"):
        Adam([param, cpu], lr=LR).step()


@pytest.mark.gpu
def test_train_step_on_card_runs_the_pass_without_a_host_sync(cuda):
    """One ``Trainer.train_step`` with batches on the card: the expected
    launches, every parameter element with a gradient updated, and no host
    sync inside ``optimizer.step()`` (sync debug mode "error")."""
    cfg = TrainConfig(batch_size=2, emd_iters=50, **SMALL)
    torch.manual_seed(0)
    trainer = Trainer(Generator(**SMALL), cfg, device=cuda)
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8, device=cuda)
    points = torch.rand(2, SMALL["num_points"], 3, device=cuda) * 0.9
    trainer.train_step(images, points, 1, LR)  # the moments exist from here on
    step = trainer.optimizer.step

    def strict_step(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    trainer.optimizer.step = strict_step
    launches = adam_kernel.launches
    trainer.train_step(images, points, 1, LR)
    torch.cuda.synchronize()
    with_grad = [p for p in trainer.model.parameters() if p.grad is not None]
    assert adam_kernel.launches - launches == math.ceil(len(with_grad) / MAX_TENSORS)
    assert adam_kernel.elements == sum(p.numel() for p in with_grad)
