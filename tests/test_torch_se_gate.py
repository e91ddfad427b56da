"""The squeeze-and-excite gate's op (``fenet_torch.ops.se_gate``): one
autograd Function whose forward is PyTorch's operations and whose backward
is CUDA kernels on the card and the plain formulas on the CPU.

On the CPU: the op against fenet's ``SEBlock`` (``fenet/models/repvgg.py``)
on the same inputs and weights, forward and ``jax.grad``; the plain backward
formulas through ``torch.autograd.gradcheck`` in float64, and against
autograd of the eager gate, in float64 to 1e-12 of each gradient's largest
element and in float32 bit for bit (the formulas are autograd's own nodes'
operations, in its order); the kernel wrapper's checks; ``SEBlock``'s
state-dict keys. On the card (``gpu``): at each of RepVGG-D2se's five gate
shapes at batch 128, the backward's kernels against the plain formulas,
twice with the same bits, and their launches; the op through autograd; a
bf16 fold of a D2se generator on the card against the same fold on the CPU.

Tolerances. Against fenet, both in float32 on the CPU: XLA and PyTorch sum
the means, the linears and the gradients' reductions (over up to 4096
terms) in their own orders, so each output is held to 1e-5 of its largest
element, about 80 float32 ulps, a hundredth of what one TF32 operand would
move it (~1e-3). On the card: the backward's kernels sum t = sum dy·x, the
two linears' transposes and the batch's parameter gradients in another
order than the plain formulas (PyTorch's reductions and cuBLAS), over up to
4096 terms: each gradient to the same 1e-5 of its largest element. The bf16
fold: fenet's bf16 tolerance (``tests/test_torch_deploy.py``), 5% of the
largest coordinate; the card's and the CPU's bf16 convolutions round in
their own orders.

Nothing here decides at import time whether there is a card; the ``cuda``
fixture does. JAX is imported only inside the test that compares with fenet,
so the ``gpu`` tests run where JAX is not installed.
"""

import dataclasses

import pytest
import torch

from fenet_torch.models.repvgg import SEBlock
from fenet_torch.ops.se_gate import (BACKWARD_LAUNCHES, gate_backward_plain, gate_forward,
                                     se_gate, se_gate_kernel)

# (C, h, w) and batches of the CPU checks.
CPU_SHAPES = [(32, 1, 1), (32, 4, 4), (64, 8, 8)]
CPU_BATCHES = [1, 3]
# RepVGG-D2se's gates at 128x128 images: (C, h = w), batch 128 on the card.
D2SE_SHAPES = [(64, 64), (160, 32), (320, 16), (640, 8), (2560, 4)]
D2SE_BATCH = 128
# D2se's gates at batch 2 against fenet on the CPU.
FENET_D2SE_BATCH = 2
# (B, C, h, w) off D2se's shapes: rows and weights whose lengths are not
# multiples of four (the kernels' scalar loops), a batch that leaves an
# excite block's samples short, one sample.
ODD_SHAPES = [(3, 48, 7, 7), (5, 36, 5, 5), (2, 50, 3, 3), (1, 160, 2, 6), (9, 2560, 1, 1)]
FENET_LIMIT = 1e-5
CARD_LIMIT = 1e-5
BF16_REL = 0.05
NAMES = ("x", "down.weight", "down.bias", "up.weight", "up.bias")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(b, c, h, w, dtype=torch.float32, device="cpu", seed=0):
    """x, down.weight, down.bias, up.weight, up.bias, dy: seeded normals,
    the weights at nn.Linear's scale."""
    gen = torch.Generator().manual_seed(seed)
    r = c // 16

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64) * scale).to(dtype).to(device)

    return (draw(b, c, h, w), draw(r, c, scale=c ** -0.5), draw(r, scale=c ** -0.5),
            draw(c, r, scale=r ** -0.5), draw(c, scale=r ** -0.5), draw(b, c, h, w))


def _gap(got, want) -> float:
    """max |got - want| over want's largest element (over the smallest
    normal float32 where want is all zero: a ReLU dead for every sample
    leaves down's gradients 0, and then got must be 0 too)."""
    return float((got - want).abs().max() / max(float(want.abs().max()),
                                                 torch.finfo(torch.float32).tiny))


def _eager_grads(inputs):
    """Autograd of the eager gate: y and the gradients of x and the four
    weights for the upstream gradient dy."""
    *args, dy = inputs
    leaves = [a.clone().requires_grad_(True) for a in args]
    y = gate_forward(*leaves)[0]
    return (y.detach(), *torch.autograd.grad(y, leaves, dy))


def _plain_grads(inputs):
    """The forward and the plain backward formulas: y and the same
    gradients."""
    *args, dy = inputs
    y, mean, hidden, gate = gate_forward(*args)
    return (y, *gate_backward_plain(dy, args[0], mean, hidden, gate, args[1], args[3]))


def _op_grads(inputs):
    """The op through autograd: y and the same gradients."""
    *args, dy = inputs
    leaves = [a.clone().requires_grad_(True) for a in args]
    y = se_gate(*leaves)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy))


def _fenet_grads(inputs):
    """fenet's ``SEBlock`` on the same x (NHWC) and weights (the Dense
    kernels are the linears' weights transposed): y and ``jax.grad`` of
    sum(y · dy) in x and the four weights, in the port's layouts."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fenet.models.repvgg import SEBlock as FenetSEBlock

    x, wd, bd, wu, bu, dy = (np.asarray(t.numpy()) for t in inputs)
    block = FenetSEBlock(channels=x.shape[1], internal=wd.shape[0])
    params = {"down": {"kernel": wd.T, "bias": bd}, "up": {"kernel": wu.T, "bias": bu}}
    x_nhwc, dy_nhwc = x.transpose(0, 2, 3, 1), dy.transpose(0, 2, 3, 1)

    def loss(p, xs):
        return jnp.sum(block.apply({"params": p}, xs) * dy_nhwc)

    y = block.apply({"params": params}, x_nhwc)
    grad_p, grad_x = jax.grad(loss, argnums=(0, 1))(params, x_nhwc)
    out = (np.asarray(y).transpose(0, 3, 1, 2), np.asarray(grad_x).transpose(0, 3, 1, 2),
           np.asarray(grad_p["down"]["kernel"]).T, np.asarray(grad_p["down"]["bias"]),
           np.asarray(grad_p["up"]["kernel"]).T, np.asarray(grad_p["up"]["bias"]))
    return tuple(torch.from_numpy(np.array(o)) for o in out)


FENET_CASES = ([(b, c, h, w) for b in CPU_BATCHES for c, h, w in CPU_SHAPES]
               + [(FENET_D2SE_BATCH, c, hw, hw) for c, hw in D2SE_SHAPES])


@pytest.mark.parametrize("b,c,h,w", FENET_CASES)
def test_op_matches_fenet_se_block(b, c, h, w):
    """The op on the CPU (PyTorch's forward, the plain backward through
    autograd) against fenet's gate and its ``jax.grad``: y and the five
    gradients, each within FENET_LIMIT of fenet's largest element."""
    inputs = _inputs(b, c, h, w, seed=b * c + h)
    got, want = _op_grads(inputs), _fenet_grads(inputs)
    for name, g, e in zip(("y",) + NAMES, got, want):
        assert g.shape == e.shape, name
        assert _gap(g, e) <= FENET_LIMIT, (name, _gap(g, e))


@pytest.mark.parametrize("b", CPU_BATCHES)
@pytest.mark.parametrize("c,h,w", CPU_SHAPES)
def test_plain_backward_passes_gradcheck(b, c, h, w):
    """The op on the CPU (the forward, the plain backward formulas) against
    finite differences in float64, in all five inputs (gradcheck's fast
    mode: random directions in and out, which covers every input)."""
    args = [a.requires_grad_(True) for a in _inputs(b, c, h, w, torch.float64)[:5]]
    assert torch.autograd.gradcheck(se_gate, args, eps=1e-6, atol=1e-8, rtol=1e-6, fast_mode=True)


@pytest.mark.parametrize("b", CPU_BATCHES)
@pytest.mark.parametrize("c,h,w", CPU_SHAPES)
def test_plain_backward_matches_autograd_of_the_eager_gate(b, c, h, w):
    """The formulas against autograd of the eager gate: float64 to 1e-12 of
    each output's largest element, float32 bit for bit."""
    want = _eager_grads(_inputs(b, c, h, w, torch.float64))
    got = _plain_grads(_inputs(b, c, h, w, torch.float64))
    for name, g, e in zip(("y",) + NAMES, got, want):
        assert g.shape == e.shape, name
        assert float((g - e).abs().max()) <= 1e-12 * float(e.abs().max()), name
    want = _eager_grads(_inputs(b, c, h, w))
    got = _plain_grads(_inputs(b, c, h, w))
    for name, g, e in zip(("y",) + NAMES, got, want):
        assert torch.equal(g, e), (name, float((g - e).abs().max()))


def test_op_on_the_cpu_is_the_plain_version():
    """se_gate on CPU tensors: the forward's bits, and the plain backward's
    gradients through autograd; no launch counted."""
    inputs = _inputs(3, 64, 8, 8)
    before = se_gate_kernel.launches
    got, want = _op_grads(inputs), _plain_grads(inputs)
    for name, g, e in zip(("y",) + NAMES, got, want):
        assert torch.equal(g, e), name
    assert se_gate_kernel.launches == before


def _bad_backward_inputs(case):
    """The kernel wrapper's arguments (dy, x, means, hidden, s, wd, wu)
    with one fault."""
    x, wd, bd, wu, bu, dy = _inputs(2, 32, 4, 4)
    _, mean, hidden, gate = gate_forward(x, wd, bd, wu, bu)
    args = [dy, x, mean, hidden, gate, wd, wu]
    if case == "dy_dtype":
        args[0] = dy.double()
    elif case == "x_dtype":
        args[1] = x.bfloat16()
    elif case == "weight_dtype":
        args[6] = wu.half()
    elif case == "dy_not_contiguous":
        args[0] = dy.transpose(2, 3)
    elif case == "x_not_contiguous":
        args[1] = x.transpose(2, 3)
    elif case == "device_mismatch":
        args[6] = torch.empty(wu.shape, device="meta")
    elif case == "shape":
        args[6] = wu[:, :1].contiguous()
    elif case == "saved_shape":
        args[4] = gate[:1]
    return args


@pytest.mark.parametrize("case,match", [
    ("dy_dtype", "dy has dtype torch.float64, needs float32"),
    ("x_dtype", "x has dtype torch.bfloat16, needs float32"),
    ("weight_dtype", "up.weight has dtype torch.float16"),
    ("dy_not_contiguous", "dy is not contiguous"),
    ("x_not_contiguous", "x is not contiguous"),
    ("device_mismatch", "up.weight is on meta, dy on cpu"),
    ("shape", "do not gate 32 channels"),
    ("saved_shape", r"s \(1, 32\) for x \(2, 32, 4, 4\)"),
    ("cpu", "not a CUDA device"),
])
def test_backward_wrapper_rejects_what_the_kernels_do_not_take(case, match):
    """The kernel wrapper checks shapes, then types, layout and devices,
    before any pointer crosses into C, so each fault raises here on the CPU
    too, and nothing is counted."""
    before = se_gate_kernel.launches
    with pytest.raises(ValueError, match=match):
        se_gate_kernel(*_bad_backward_inputs(case))
    assert se_gate_kernel.launches == before


def test_se_block_state_dict_keys_are_unchanged():
    """``down`` and ``up`` stay nn.Linear: the published names and shapes,
    and a state of the eager gate's era loads strict."""
    block = SEBlock(64, 4)
    sd = block.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        "down.weight": (4, 64), "down.bias": (4,), "up.weight": (64, 4), "up.bias": (64,)}
    assert isinstance(block.down, torch.nn.Linear) and isinstance(block.up, torch.nn.Linear)
    block.load_state_dict({k: torch.randn_like(v) for k, v in sd.items()}, strict=True)


def _gaps(got, want):
    return {name: _gap(g, e) for name, g, e in zip(NAMES, got[1:], want[1:])}


def _kernel_grads(inputs):
    """The forward and the kernels' backward: y and the five gradients."""
    *args, dy = inputs
    y, mean, hidden, gate = gate_forward(*args)
    return (y, *se_gate_kernel(dy, args[0], mean, hidden, gate, args[1], args[3]))


def _assert_kernels_match_plain(inputs):
    """The kernels' gradients against the plain formulas' on the card,
    BACKWARD_LAUNCHES launches a call; returns the kernels' outputs."""
    want = _plain_grads(inputs)
    before = se_gate_kernel.launches
    got = _kernel_grads(inputs)
    torch.cuda.synchronize()
    assert se_gate_kernel.launches == before + BACKWARD_LAUNCHES
    gaps = _gaps(got, want)
    assert all(gap <= CARD_LIMIT for gap in gaps.values()), gaps
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("c,hw", D2SE_SHAPES)
def test_kernels_match_plain_on_card(cuda, c, hw):
    """At each D2se gate shape, batch 128: the five gradients against the
    plain formulas on the card (module docstring), the same bits on a
    second call, and BACKWARD_LAUNCHES launches a call."""
    inputs = _inputs(D2SE_BATCH, c, hw, hw, device=cuda, seed=c)
    got = _assert_kernels_match_plain(inputs)
    again = _kernel_grads(inputs)
    torch.cuda.synchronize()
    for name, a, b in zip(("y",) + NAMES, got, again):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("b,c,h,w", ODD_SHAPES)
def test_kernels_match_plain_on_card_at_odd_shapes(cuda, b, c, h, w):
    """Shapes that take the kernels' scalar loops and short excite blocks:
    the same comparison and launches as at D2se's shapes."""
    _assert_kernels_match_plain(_inputs(b, c, h, w, device=cuda, seed=b * c))


@pytest.mark.gpu
def test_op_on_card_runs_the_kernels_through_autograd(cuda):
    """se_gate on CUDA tensors: the forward's and the kernels' bits through
    autograd; in bf16 the forward is PyTorch's operations in bf16, and a
    backward raises rather than falling back."""
    inputs = _inputs(4, 160, 32, 32, device=cuda)
    before = se_gate_kernel.launches
    got = _op_grads(inputs)
    assert se_gate_kernel.launches == before + BACKWARD_LAUNCHES
    for name, g, e in zip(("y",) + NAMES, got, _kernel_grads(inputs)):
        assert torch.equal(g, e), name
    half = [t.bfloat16() for t in inputs[:5]]
    with torch.no_grad():
        y = se_gate(*half)
    assert y.dtype == torch.bfloat16 and torch.equal(y, gate_forward(*half)[0])
    leaves = [t.requires_grad_(True) for t in half]
    with pytest.raises(ValueError, match="needs float32"):
        se_gate(*leaves).sum().backward()


@pytest.mark.gpu
def test_bf16_d2se_fold_on_card_matches_the_cpu(cuda, monkeypatch):
    """A bf16 fold (``to_deploy``) of the generator on D2se's 48 gated blocks
    (widths [0.25] * 4, entered in the registry for the test) runs on the
    card, gates included, and its clouds lie within BF16_REL of the largest
    coordinate of the same fold's on the CPU."""
    from fenet_torch.models import repvgg
    from fenet_torch.models.generator import Generator, init_random_, to_deploy

    name = "RepVGG-D2se-SMALL"
    monkeypatch.setitem(repvgg.REPVGG_CONFIGS, name, dataclasses.replace(
        repvgg.REPVGG_CONFIGS["RepVGG-D2se"], width_multiplier=[0.25] * 4))
    gen = init_random_(Generator(num_points=256, backbone=name, fine_width=32, mid_width=16),
                       torch.Generator().manual_seed(0))
    fold = to_deploy(gen, torch.bfloat16)
    images = torch.randint(0, 256, (2, 128, 128, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        want = fold(images)[2].float()
        got = fold.to(cuda)(images.to(cuda))[2]
    assert got.dtype == torch.bfloat16
    got = got.float().cpu()
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max() / want.abs().max()) < BF16_REL
