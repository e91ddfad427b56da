"""The ring-sharded chamfer (fenet_torch.parallel.sp) in D = 2 and 4 gloo
ranks on the CPU, against fenet's ``make_sharded_chamfer`` on D virtual CPU
devices (``tests/conftest.py``) and against the port's one-process
``chamfer_distance``.

- Dyadic clouds (coordinates k/64, where every product and sum is exact),
  N ≠ M too, and one with a target point planted on three shards (the first
  global index must win, as in ``tests/test_sp.py``): the distances,
  indices and both clouds' gradients of a weighted sum of the distances
  equal the one-process op's and fenet's bit for bit.
- Random normal clouds: the indices equal both bit for bit; the distances
  agree to rtol 1e-6 / atol 1e-6 (fenet's test's), the gradients to 1e-6 against the one-process op (the
  ring adds the cross terms in another order) and to fenet's own tests'
  1e-5 against fenet. The distances are not bit-exact here: the plain
  version's CPU matmul rounds the K=3 cross term differently at some block
  shapes (measured at 16×8 blocks, not at 32×32), and fenet's XLA dot
  differs from torch's in the last bit. K1 on the card computes a pair's
  distance the same way in any block, and ``chip_smoke.py`` holds the ring
  to the one-process op bit for bit there.
- K1's function (``nearest_neighbour``) runs 2·D times a forward on every
  rank; N not divisible by D raises.

Each rank is this file run as a script, without JAX (torch autograd and
XLA:CPU corrupt the heap in one process), under a subprocess timeout.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

from torch_ranks import PG_TIMEOUT_S, env, free_port, run


def _child_ring(spec: dict) -> None:
    from fenet_torch.ops.chamfer import chamfer_distance
    from fenet_torch.parallel import sp
    from fenet_torch.parallel.distributed import initialize

    torch.set_num_threads(1)
    initialize(f"127.0.0.1:{spec['port']}", spec["world"], spec["rank"], backend="gloo",
               device="cpu", timeout_s=PG_TIMEOUT_S)
    blob = np.load(spec["inputs"])
    calls = []
    nearest = sp.nearest_neighbour

    def counted(a, b):
        calls.append(1)
        return nearest(a, b)

    sp.nearest_neighbour = counted
    x1, x2, w1, w2 = (torch.tensor(blob[k]) for k in ("x1", "x2", "w1", "w2"))
    a = sp.shard_points(x1).requires_grad_(True)
    b = sp.shard_points(x2).requires_grad_(True)
    d1, d2, i1, i2 = sp.make_sharded_chamfer()(a, b)
    launches = len(calls)
    ((d1 * sp.shard_points(w1)).sum() + (d2 * sp.shard_points(w2)).sum()).backward()
    out = {"d1": d1.detach(), "d2": d2.detach(), "i1": i1, "i2": i2, "g1": a.grad,
           "g2": b.grad}
    if spec["rank"] == 0:  # the one-process op on the whole clouds
        a, b = x1.clone().requires_grad_(True), x2.clone().requires_grad_(True)
        r1, r2, j1, j2 = chamfer_distance(a, b)
        ((r1 * w1).sum() + (r2 * w2).sum()).backward()
        out.update({"ref.d1": r1.detach(), "ref.d2": r2.detach(), "ref.i1": j1, "ref.i2": j2,
                    "ref.g1": a.grad, "ref.g2": b.grad})
    try:
        sp.shard_points(x1[:, :-1])
        raises = False
    except ValueError:
        raises = True
    np.savez(Path(spec["out"]) / f"rank{spec['rank']}.npz", launches=launches, raises=raises,
             **{k: v.numpy() for k, v in out.items()})


if __name__ == "__main__":
    _child_ring(json.loads(Path(sys.argv[1]).read_text()))
    raise SystemExit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from fenet.parallel.sp import make_point_mesh, make_sharded_chamfer  # noqa: E402
from torch_tmp import remove_tmp_path  # noqa: E402,F401  (deletes each test's tmp_path)


def _clouds(kind, n, m, b=2, seed=0):
    rng = np.random.RandomState(seed)
    if kind == "random":
        x1, x2 = rng.normal(size=(b, n, 3)), rng.normal(size=(b, m, 3))
        w1, w2 = rng.rand(b, n), rng.rand(b, m)
    else:
        x1 = rng.randint(-64, 65, (b, n, 3)) / 64.0
        x2 = rng.randint(-64, 65, (b, m, 3)) / 64.0
        w1, w2 = rng.randint(1, 9, (b, n)) / 8.0, rng.randint(1, 9, (b, m)) / 8.0
    if kind == "ties":  # one target on shards 0, 2 and 3 of 4; its twin in x1
        x2[0, 0] = x2[0, m // 2 + 1] = x2[0, m - 3] = [0.5, 0.5, 0.5]
        x1[0, 3] = [0.5, 0.5, 0.5]
    return tuple(np.asarray(x, np.float32) for x in (x1, x2, w1, w2))


def _ring(tmp_path, d, x1, x2, w1, w2):
    """The ring in d ranks: each output concatenated over the ranks'
    blocks, rank 0's one-process reference, and each rank's launches."""
    np.savez(tmp_path / "inputs.npz", x1=x1, x2=x2, w1=w1, w2=w2)
    port = free_port()
    argvs = []
    for rank in range(d):
        spec = tmp_path / f"spec{rank}.json"
        spec.write_text(json.dumps({"inputs": str(tmp_path / "inputs.npz"), "out": str(tmp_path),
                                    "world": d, "rank": rank, "port": port}))
        argvs.append([sys.executable, __file__, str(spec)])
    run(argvs, [env()] * d)
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(d)]
    got = {k: np.concatenate([r[k] for r in ranks], axis=1)
           for k in ("d1", "d2", "i1", "i2", "g1", "g2")}
    ref = {k[4:]: v for k, v in ranks[0].items() if k.startswith("ref.")}
    return got, ref, ranks


def _fenet(d, x1, x2, w1, w2):
    chamfer = make_sharded_chamfer(make_point_mesh(d))

    def loss(a, b):
        d1, d2, _, _ = chamfer(a, b)
        return jnp.sum(d1 * w1) + jnp.sum(d2 * w2)

    d1, d2, i1, i2 = chamfer(jnp.asarray(x1), jnp.asarray(x2))
    g1, g2 = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x1), jnp.asarray(x2))
    return {k: np.asarray(v) for k, v in zip(("d1", "d2", "i1", "i2", "g1", "g2"),
                                             (d1, d2, i1, i2, g1, g2))}


CASES = [("random", 2, 64, 64), ("random", 4, 64, 32), ("dyadic", 4, 32, 64),
         ("dyadic", 2, 48, 48), ("ties", 4, 8, 32)]


@pytest.mark.parametrize("kind,d,n,m", CASES, ids=[f"{k}-D{d}-{n}x{m}" for k, d, n, m in CASES])
def test_ring_chamfer_matches_one_process_and_fenet(kind, d, n, m, tmp_path):
    x1, x2, w1, w2 = _clouds(kind, n, m, seed=d + n)
    got, ref, ranks = _ring(tmp_path, d, x1, x2, w1, w2)
    theirs = _fenet(d, x1, x2, w1, w2)
    for key in ("i1", "i2"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(got[key], theirs[key], err_msg=key)
    if kind == "random":
        # atol as tests/test_sp.py: the formula's terms reach ~6 here, whose
        # float32 spacing is 4.8e-7 (measured 9.5e-7 apart at most).
        for key in ("d1", "d2"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=1e-6, err_msg=key)
            np.testing.assert_allclose(got[key], theirs[key], rtol=1e-6, atol=1e-6, err_msg=key)
        for key in ("g1", "g2"):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=1e-7, err_msg=key)
            np.testing.assert_allclose(got[key], theirs[key], rtol=1e-5, atol=1e-6, err_msg=key)
    else:
        for key in ("d1", "d2", "g1", "g2"):
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
            np.testing.assert_array_equal(got[key], theirs[key], err_msg=key)
    if kind == "ties":
        assert got["i1"][0, 3] == 0  # the first of the three copies
    assert [int(r["launches"]) for r in ranks] == [2 * d] * d
    assert all(bool(r["raises"]) for r in ranks)  # n - 1 points do not split
