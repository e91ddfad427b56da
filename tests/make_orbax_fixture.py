"""fenet's orbax container as fenet writes it, for the port's readers.

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py

writes ``tests/fixtures/fenet_orbax/`` afresh with fenet's own
``save_checkpoint(..., fmt="orbax")`` (orbax and tensorstore): the
directory ``02828884_checkpoint_7.orbax`` (a tensorstore OCDBT store of
zstd-compressed zarr v2 arrays) and its JSON sidecar. The tree is
:func:`seeded_tree`'s, made with numpy from :data:`SEED`, in the shape of
a fenet training state: ``params``, an empty ``batch_stats`` and optax's
``chain(add_decayed_weights, scale_by_adam)`` state, whose ``EmptyState``
orbax writes as an empty node. Its leaves: a random float32 kernel of
512 KiB (its zstd frame has several blocks with Huffman-coded literals),
first and second moments of few distinct values (long matches), a bfloat16
leaf with its moments, the int32 step count and small leaves that the
store keeps inline in its b-tree node. The file names under ``d/`` are
random, so each run writes other names with the same content.

:func:`seeded_tree` imports numpy alone: the port's tests and
``chip_smoke.py`` rebuild the arrays with it and hold every leaf the port
reads against them. A bfloat16 leaf is given by its bits, as uint16.
"""

import os
import shutil
import sys
from pathlib import Path

import numpy as np

SEED = 15
CATEGORY = "02828884"
EPOCH = 7
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "fenet_orbax"
CHECKPOINT = FIXTURE / f"{CATEGORY}_checkpoint_{EPOCH}.orbax"
META = {"epoch": EPOCH, "model_name": "fenet", "train_time": 12.5,
        "best_chamfer_loss": 0.25, "best_emd_loss": float("nan")}


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bfloat16 (to nearest even), as uint16 bits."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def seeded_tree() -> dict:
    """The fixture's arrays, keys sorted: ``{"batch_stats": {}, "opt_state":
    {"0": {}, "1": {"count", "mu", "nu"}}, "params"}``."""
    rng = np.random.RandomState(SEED)
    params = {
        "dense": {"kernel": rng.randn(256, 512).astype(np.float32),  # 512 KiB
                  "bias": rng.randn(512).astype(np.float32)},
        "embed": {"table": bf16_bits(rng.randn(48, 24))},
        "norm": {"scale": (1 + 0.1 * rng.randn(16)).astype(np.float32),
                 "bias": (0.1 * rng.randn(16)).astype(np.float32)},
        "conv": {"kernel": rng.randn(3, 3, 2, 4).astype(np.float32)},
    }

    def moment(x, scale, square):
        if x.dtype == np.uint16:
            values = rng.randint(-4, 5, x.shape).astype(np.float32) * scale
            return bf16_bits(values ** 2 if square else values)
        values = rng.randint(-8, 9, x.shape).astype(np.float32) * scale
        return values ** 2 if square else values

    sort = lambda tree: {k: sort(tree[k]) for k in sorted(tree)} \
        if isinstance(tree, dict) else tree  # noqa: E731
    mu = {m: {k: moment(v, np.float32(1 / 64), False) for k, v in leaves.items()}
          for m, leaves in params.items()}
    nu = {m: {k: moment(v, np.float32(1 / 256), True) for k, v in leaves.items()}
          for m, leaves in params.items()}
    return sort({"params": params, "batch_stats": {},
                 "opt_state": {"0": {}, "1": {"count": np.asarray(EPOCH * 3, np.int32),
                                              "mu": mu, "nu": nu}}})


def _to_jax(tree):
    """uint16 bits -> bfloat16 arrays, and optax's state as optax's types."""
    import jax.numpy as jnp
    import optax

    def leaves(t):
        if isinstance(t, dict):
            return {k: leaves(v) for k, v in t.items()}
        return jnp.asarray(t.view(jnp.bfloat16)) if t.dtype == np.uint16 else t

    adam = tree["opt_state"]["1"]
    opt_state = (optax.EmptyState(), optax.ScaleByAdamState(
        count=adam["count"], mu=leaves(adam["mu"]), nu=leaves(adam["nu"])))
    return {"params": leaves(tree["params"]), "batch_stats": {}, "opt_state": opt_state}


def main() -> None:
    sys.path.insert(0, str(FIXTURE.parent.parent.parent))
    from fenet.train.checkpoint import save_checkpoint

    shutil.rmtree(FIXTURE, ignore_errors=True)
    path = save_checkpoint({**_to_jax(seeded_tree()), **META}, False, CATEGORY,
                           str(FIXTURE), EPOCH, fmt="orbax")
    size = sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file())
    print(f"{path}: {size} bytes in {sum(1 for f in FIXTURE.rglob('*') if f.is_file())} files")


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    main()
