"""The chamfer nearest-neighbour kernel's split of M (csrc/chamfer_nn.cu):
a torch model of the merge, the choice of S, and, on a card, the kernel
against the plain version bit for bit.

With S > 1, block z of S scans the tiles [z T / S, (z + 1) T / S) of the T
tiles of M and merges each row's (d, j) into a 64-bit key, d's bits high
and j low, with atomicMin in whatever order the blocks finish. The model
below does the same with torch on the distance matrix and must give the
plain version's and fenet's Pallas kernel's dist and first argmin, bit for
bit, in any order of slices.

Tests marked ``gpu`` skip without a card. On the card, which has no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_chamfer.py``.
"""

import ctypes
import types

import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from fenet.ops.chamfer import _nn_pallas
except ImportError:
    # The card machine has no JAX; there only the gpu tests run.
    pass
from fenet_torch.ops import _build
from fenet_torch.ops.chamfer import (
    BLOCKS_TARGET,
    ROWS_PER_BLOCK,
    SMS,
    TILE,
    _nn_ref,
    nn_kernel,
    nn_slices,
)
from fenet_torch.ops.pairwise import pairwise_sqdist

ALL_ONES = 2 ** 63 - 1  # the keys' start: above every key of a finite d >= 0


def _slice_bounds(m, slices, tile):
    """[lo, hi) of M for each block z, as the kernel computes them."""
    tiles = -(-m // tile)
    return [((z * tiles // slices) * tile, min(((z + 1) * tiles // slices) * tile, m))
            for z in range(slices)]


def _split_nn(a, b, slices, tile, order):
    """The kernel's split in torch: each slice's (min, first argmin) packed
    into a key, the keys merged by min in ``order``, then unpacked."""
    d = pairwise_sqdist(a, b)
    keys = []
    for lo, hi in _slice_bounds(b.shape[1], slices, tile):
        dz, jz = torch.min(d[..., lo:hi], dim=-1)
        keys.append((dz.view(torch.int32).to(torch.int64) << 32) | (jz + lo))
    merged = torch.full_like(keys[0], ALL_ONES)
    for z in order:
        merged = torch.minimum(merged, keys[z])
    return (merged >> 32).to(torch.int32).view(torch.float32), (merged & 0xFFFFFFFF).to(torch.int32)


def _tied_clouds(rng, bsz, n, m):
    """Dyadic clouds (coordinates k/8) with ties built in: B points repeated
    at the far end of M, so equal distances fall in different slices, and A
    points that lie in B (d = 0)."""
    a = rng.randint(-8, 9, size=(bsz, n, 3)) / 8.0
    b = rng.randint(-8, 9, size=(bsz, m, 3)) / 8.0
    k = m // 4
    b[:, m - k:] = b[:, :k]
    a[:, : n // 4] = b[:, rng.randint(0, m, size=n // 4)]
    return a.astype(np.float32), b.astype(np.float32)


def _orders(slices, kind):
    if kind == "forward":
        return range(slices)
    if kind == "reverse":
        return reversed(range(slices))
    return np.random.RandomState(slices).permutation(slices)


@pytest.mark.parametrize("order", ["forward", "reverse", "shuffled"])
@pytest.mark.parametrize("slices", [1, 2, 3, 7])
def test_split_merge_matches_plain_and_pallas(slices, order):
    """M = 61 in tiles of 8: 7 whole tiles and a partial one, so the slices
    hold whole tiles and the last one the partial tile."""
    rng = np.random.RandomState(40 + slices)
    a, b = _tied_clouds(rng, 2, 40, 61)
    at, bt = torch.tensor(a), torch.tensor(b)
    if slices > 1:  # the case tests ties across slices only if it has them
        d = pairwise_sqdist(at, bt)
        hit = d == d.amin(dim=-1, keepdim=True)
        per_slice = torch.stack([hit[..., lo:hi].any(-1)
                                 for lo, hi in _slice_bounds(61, slices, 8)])
        assert int((per_slice.sum(0) > 1).sum()) > 0
        assert int((d.amin(dim=-1) == 0).sum()) >= 10
    dist, idx = _split_nn(at, bt, slices, 8, _orders(slices, order))
    d_ref, i_ref = _nn_ref(at, bt)
    assert torch.equal(dist, d_ref) and torch.equal(idx, i_ref)
    d_pal, i_pal = _nn_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True)
    np.testing.assert_array_equal(dist.numpy(), np.asarray(d_pal))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(i_pal))


@pytest.mark.parametrize("slices", [2, 3, 7])
def test_split_merge_clamps_negative_distances(slices):
    """A points copied from B on normal coordinates: (aa + bb) - 2ab rounds
    below 0 for some of them, is clamped to +0, and ties with the other
    copies; the merged keys keep the first j."""
    rng = np.random.RandomState(50)
    b = rng.randn(2, 61, 3).astype(np.float32)
    b[:, 40:] = b[:, :21]
    a = np.concatenate([b[:, rng.randint(0, 61, size=30)], rng.randn(2, 10, 3)], axis=1)
    at, bt = torch.tensor(a.astype(np.float32)), torch.tensor(b)
    ab = torch.matmul(at, bt.transpose(-1, -2))
    sq = lambda x: x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]
    raw = (sq(at)[..., :, None] + sq(bt)[..., None, :]) - 2.0 * ab
    assert bool((raw < 0).any())
    dist, idx = _split_nn(at, bt, slices, 8, _orders(slices, "shuffled"))
    d_ref, i_ref = _nn_ref(at, bt)
    assert torch.equal(dist, d_ref) and torch.equal(idx, i_ref)


@pytest.mark.parametrize("shape", [
    (128, 1024, 1024), (128, 2048, 2048), (4, 2048, 16384), (16, 1024, 1024),
    (64, 1024, 1024), (64, 2048, 2048), (4, 1000, 1100), (1, 1, 1), (3, 777, 5),
])
def test_nn_slices_cover_m(shape):
    bsz, n, m = shape
    s = nn_slices(bsz, n, m)
    assert 1 <= s <= -(-m // TILE)
    bounds = _slice_bounds(m, s, TILE)
    assert bounds[0][0] == 0 and bounds[-1][1] == m
    assert all(lo < hi for lo, hi in bounds)
    assert all(bounds[z][1] == bounds[z + 1][0] for z in range(s - 1))
    row_blocks = bsz * -(-n // ROWS_PER_BLOCK)
    if row_blocks >= SMS:
        assert s == 1
    else:
        assert row_blocks * s <= BLOCKS_TARGET + row_blocks


def test_nn_slices_at_the_step_shapes():
    """The train step keeps one launch a direction: S = 1 at batch 128; the
    small grids split."""
    assert nn_slices(128, 1024, 1024) == 1 and nn_slices(128, 2048, 2048) == 1
    assert nn_slices(4, 2048, 16384) > 1 and nn_slices(16, 1024, 1024) > 1


def test_bind_sets_types_once_and_skips_missing_symbols():
    fn = types.SimpleNamespace()
    lib = types.SimpleNamespace(fenet_chamfer_nn_split=fn)
    assert _build.bind("chamfer_nn", lib) is lib
    argtypes, restype = _build.SIGNATURES["chamfer_nn"]["fenet_chamfer_nn_split"]
    assert fn.argtypes == argtypes and fn.restype is restype
    assert fn.argtypes[4] is ctypes.c_void_p and fn.argtypes[-1] is ctypes.c_void_p
    old = types.SimpleNamespace(fenet_chamfer_nn=types.SimpleNamespace())
    assert _build.bind("chamfer_nn", old) is old
    assert not hasattr(old.fenet_chamfer_nn, "argtypes")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _exact_on_card(cuda, a, b, slices=None):
    at, bt = torch.tensor(a, device=cuda), torch.tensor(b, device=cuda)
    before = nn_kernel.launches
    d_k, i_k = nn_kernel(at, bt, slices)
    torch.cuda.synchronize()
    assert nn_kernel.launches == before + 1
    d_p, i_p = _nn_ref(at, bt)
    assert d_k.is_contiguous() and i_k.is_contiguous()
    assert torch.equal(d_k, d_p) and torch.equal(i_k, i_p)


@pytest.mark.gpu
@pytest.mark.parametrize("slices", [2, 5, 12])
def test_nn_kernel_split_with_ties_across_slices_on_card(cuda, slices):
    rng = np.random.RandomState(60 + slices)
    a, b = _tied_clouds(rng, 3, 1000, 3000)
    _exact_on_card(cuda, a, b, slices)


@pytest.mark.gpu
def test_nn_kernel_one_slice_at_the_train_shape_on_card(cuda):
    assert nn_slices(128, 1024, 1024) == 1
    a, b = _tied_clouds(np.random.RandomState(61), 128, 1024, 1024)
    _exact_on_card(cuda, a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,slices", [
    ((2, 513, 257), None), ((2, 513, 257), 2), ((5, 1000, 1100), None), ((3, 1025, 700), 3),
])
def test_nn_kernel_ragged_sizes_on_card(cuda, shape, slices):
    """N off the rows per block, M off the tile."""
    bsz, n, m = shape
    a, b = _tied_clouds(np.random.RandomState(n + m), bsz, n, m)
    _exact_on_card(cuda, a, b, slices)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 9, 3), (3, 777, 5)])
def test_nn_kernel_tiny_clouds_on_card(cuda, shape):
    """N = M = 1, and M below the rows a thread holds."""
    bsz, n, m = shape
    rng = np.random.RandomState(62)
    a = (rng.randint(-8, 9, size=(bsz, n, 3)) / 8.0).astype(np.float32)
    b = (rng.randint(-8, 9, size=(bsz, m, 3)) / 8.0).astype(np.float32)
    _exact_on_card(cuda, a, b)


@pytest.mark.gpu
def test_nn_kernel_k2_range_splits_on_card(cuda):
    assert nn_slices(4, 2048, 16384) > 1
    a, b = _tied_clouds(np.random.RandomState(63), 4, 2048, 16384)
    _exact_on_card(cuda, a, b)


@pytest.mark.gpu
def test_nn_kernel_geometry_and_slice_limit_on_card(cuda):
    """The library's shape is the one nn_slices assumes; S above the tiles
    of M is refused at launch."""
    lib = _build.library("chamfer_nn")
    assert ctypes.c_int.in_dll(lib, "fenet_chamfer_nn_rows_per_block").value == ROWS_PER_BLOCK
    assert ctypes.c_int.in_dll(lib, "fenet_chamfer_nn_tile").value == TILE
    x = torch.zeros(1, 8, 3, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        nn_kernel(x, torch.zeros(1, TILE + 1, 3, device=cuda), slices=3)
