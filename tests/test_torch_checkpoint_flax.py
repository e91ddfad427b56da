"""fenet's flax checkpoint container in fenet_torch, against fenet and flax:
the msgpack codec against ``flax.serialization``, training checkpoints in
both directions, a resumed train step against fenet's, the eval and deploy
CLIs on a tree that holds only fenet's ``model_best.ckpt``, ``predict`` from
fenet's ``model_deploy.ckpt``, the port's imports with flax, msgpack, JAX
and fenet blocked, and the small helpers of fenet the port had lacked.

Torch autograd and XLA:CPU corrupt the heap when both run in one process,
so the port's resumed step runs in a subprocess: this file run as a script
(``python tests/test_torch_checkpoint_flax.py <in.npz> <out.npz>``, which
imports no JAX).

Tolerances. The codec and the containers bit for bit (bytes, arrays,
sidecars). The resumed step, as ``tests/test_torch_train.py``'s train
steps: losses to rtol 5e-3, and the train test's rtol 5e-2 on every
parameter and both Adam moments, with an absolute floor for elements near
zero: for a parameter 2·lr (a step moves a weight by at most ~lr, since
|m̂|/√v̂ ≤ ~1, and where float noise in a near-zero gradient flips the
sign of its first moment the two weights land up to ~2·lr apart; measured
8.7e-4 at lr 5e-4), for a moment 5e-2 of the tensor's largest magnitude
(the gradients differ by float noise, and the chamfer's nearest
neighbours may resolve a near-tie the other way; measured 2.4%); the step
count exactly. In the step the port replays the assignments fenet's
auction made, as that test does. The eval CLIs as
``tests/test_torch_deploy.py`` (CD rtol 1e-5, EMD rtol 5e-2); the deploy
forward rtol 1e-4 / atol 1e-3 in float32 and 5% of max|ref| in bf16 (its
bounds).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
N_POINTS, BATCH, EMD_ITERS = 256, 2, 300


def _port_resume(in_path: str, out_path: str) -> None:
    """One train step of the port's Trainer on the CPU, resumed from the
    ``.ckpt`` the input names, replaying the recorded assignment."""
    from fenet_torch.models.convert import param_names
    from fenet_torch.models.generator import Generator
    from fenet_torch.ops import emd
    from fenet_torch.ops.pairwise import sqnorm
    from fenet_torch.train.checkpoint import load_checkpoint
    from fenet_torch.train.config import TrainConfig
    from fenet_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    blob = np.load(in_path)
    assignment = torch.tensor(blob["assignment"], dtype=torch.int32)

    def replay(x1, x2, *args):
        return sqnorm(x1 - x2.gather(1, assignment.long()[..., None].expand(-1, -1, 3))), \
            assignment

    emd._auction_plain = replay
    ckpt = load_checkpoint(str(blob["ckpt"]))
    cfg = TrainConfig(batch_size=BATCH, num_points=N_POINTS, emd_iters=EMD_ITERS, **SMALL)
    trainer = Trainer(Generator(num_points=N_POINTS, **SMALL), cfg, device="cpu")
    trainer.load_full_state(ckpt["state_dict"], ckpt["optimizer"])
    stats = trainer.train_step(blob["img"], blob["pt"], 1, float(blob["lr"]))
    state_dict, optimizer = trainer.full_state()
    names = param_names(state_dict)
    out = {"losses": np.asarray([float(stats[k]) for k in
                                 ("total_loss", "chamfer_loss", "emd_loss")])}
    for i, name in enumerate(names):
        entry = optimizer["state"][i]
        out[f"param.{name}"] = state_dict[name].numpy()
        out[f"mu.{name}"] = entry["exp_avg"].numpy()
        out[f"nu.{name}"] = entry["exp_avg_sq"].numpy()
        out["step"] = float(entry["step"])
    np.savez(out_path, **out)


if __name__ == "__main__":
    _port_resume(sys.argv[1], sys.argv[2])
    raise SystemExit(0)

import json  # noqa: E402
import shutil  # noqa: E402

import flax.serialization  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from fenet.cli.eval_shapenet import main as jax_eval_main  # noqa: E402
from fenet.cli.export_deploy import load_deploy_checkpoint as jax_load_deploy  # noqa: E402
from fenet.cli.export_deploy import main as jax_export_main  # noqa: E402
from fenet.cli.predict import main as jax_predict_main  # noqa: E402
from fenet.models.convert import merge_variables, torch_state_dict_to_variables  # noqa: E402
from fenet.models.generator import Generator as JaxGenerator  # noqa: E402
from fenet.models.generator import init_variables  # noqa: E402
from fenet.models.generator import transpose_clouds as jax_transpose_clouds  # noqa: E402
from fenet.models.repvgg import create_repvgg as jax_create_repvgg  # noqa: E402
from fenet.ops.chamfer import chamfer_distance_ref as jax_chamfer_distance_ref  # noqa: E402
from fenet.ops.emd import earth_mover_distance as jax_emd  # noqa: E402
from fenet.train.checkpoint import fetch_arrays  # noqa: E402
from fenet.train.checkpoint import load_checkpoint as jax_load_checkpoint  # noqa: E402
from fenet.train.checkpoint import save_checkpoint as jax_save_checkpoint  # noqa: E402
from fenet.train.config import TrainConfig as JaxTrainConfig  # noqa: E402
from fenet.train.trainer import Trainer as JaxTrainer  # noqa: E402
from fenet.train.trainer import reference_lr_schedule as jax_lr_schedule  # noqa: E402
from fenet.utils import average_meter as jax_average_meter  # noqa: E402
from fenet_torch.cli import eval_shapenet, export_deploy, predict  # noqa: E402
from fenet_torch.data.synthetic import write_synthetic_shapenet  # noqa: E402
from fenet_torch.models.convert import (  # noqa: E402
    param_names,
    state_dict_from_jax,
    variables_from_state_dict,
)
from fenet_torch.models.generator import (  # noqa: E402
    Generator,
    SimpleGenerator,
    init_random_,
    transpose_clouds,
)
from fenet_torch.models.repvgg import REPVGG_CONFIGS, create_repvgg  # noqa: E402
from fenet_torch.ops.chamfer import chamfer_distance_ref  # noqa: E402
from fenet_torch.train import checkpoint, flax_msgpack  # noqa: E402
from fenet_torch.train.driver import _newest_checkpoint  # noqa: E402
from fenet_torch.utils import average_meter  # noqa: E402
from fenet_torch.utils.ply import load_pointcloud  # noqa: E402
from torch_tmp import remove_tmp_path  # noqa: E402,F401  (deletes each test's tmp_path)

LOSS_RTOL, PARAM_RTOL = 5e-3, 5e-2
MOMENT_RTOL, MOMENT_ATOL_REL = 5e-2, 5e-2
CD_RTOL, EMD_RTOL = 1e-5, 5e-2
RTOL, ATOL, BF16_REL = 1e-4, 1e-3, 0.05
ARCH = ["--num_points", str(N_POINTS), "--backbone", SMALL["backbone"],
        "--fine_width", "32", "--mid_width", "16"]
CAT = "02691156"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sorted(tree):
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def _assert_trees_equal(got, want, path=""):
    """Same keys in the same order, leaves of the same type, dtype, shape
    and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        return
    if isinstance(got, torch.Tensor):  # bfloat16: numpy holds it as ml_dtypes'
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16", path
        got = got.view(torch.int16).numpy()
        want = np.asarray(want).view(np.int16)
    assert type(got) is type(want), (path, type(got), type(want))
    if isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want or (got != got and want != want), path


def _batch(rng):
    imgs = (rng.rand(BATCH, 128, 128, 3) * 255).astype(np.float32)
    pts = (rng.rand(BATCH, N_POINTS, 3) * 0.9).astype(np.float32)
    return imgs, pts


def _port_init_variables(model, seed=0):
    """fenet's variables of the port's seeded init (torch's default
    distributions, as the reference trains from)."""
    gen = init_random_(Generator(num_points=N_POINTS, **SMALL), torch.Generator().manual_seed(seed))
    init = jax.tree_util.tree_map(np.asarray, init_variables(
        model, np.zeros((1, 128, 128, 3), np.float32), rng=jax.random.PRNGKey(0)))
    converted = torch_state_dict_to_variables(gen.state_dict())
    return {col: merge_variables(init[col], converted[col]) for col in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def fenet_run(tmp_path_factory):
    """fenet trains one step from the port's init and saves it as its
    driver does (``{cat}_checkpoint_1.ckpt`` and ``model_best.ckpt`` with
    their sidecars); then the next batch, its LR and the assignment fenet's
    auction makes for it. The directory is deleted after the module."""
    model = JaxGenerator(num_points=N_POINTS, **SMALL)
    cfg = JaxTrainConfig(batch_size=BATCH, num_points=N_POINTS, emd_iters=EMD_ITERS, **SMALL)
    trainer = JaxTrainer(model, cfg)
    state = trainer.state_from_variables(_port_init_variables(model))
    rng = np.random.RandomState(1)
    lr = jax_lr_schedule(cfg.lr, 1)
    img, pt = _batch(rng)
    state, _ = trainer.train_step(state, jnp.asarray(img), jnp.asarray(pt), 1, lr)
    arrays = fetch_arrays({"params": state.params, "batch_stats": state.batch_stats,
                           "opt_state": state.opt_state})
    ckpt_dir = tmp_path_factory.mktemp("fenet_run") / "checkpoints"
    meta = {"epoch": 1, "model_name": str(ckpt_dir), "train_time": 0.25,
            "best_chamfer_loss": 0.125, "best_emd_loss": float("nan")}
    path = jax_save_checkpoint({**arrays, **meta}, True, CAT, str(ckpt_dir), 1, fmt="flax")
    img, pt = _batch(rng)
    (_, _, pc3), _ = model.apply({"params": state.params, "batch_stats": state.batch_stats},
                                 jnp.asarray(img), train=True, mutable=["batch_stats"])
    assignment = np.asarray(jax_emd(pc3, jnp.asarray(pt), cfg.emd_eps, cfg.emd_iters)[1])
    yield dict(model=model, cfg=cfg, trainer=trainer, state=state, arrays=arrays, meta=meta,
               path=path, ckpt_dir=ckpt_dir, img=img, pt=pt, lr=lr, assignment=assignment)
    shutil.rmtree(ckpt_dir.parent, ignore_errors=True)


# -- (a) the codec against flax.serialization ---------------------------------

def test_dumps_is_to_bytes_on_a_post_step_state(fenet_run):
    """The post-step tree of params, batch_stats and optax's chain state:
    the port's bytes are flax's, and fenet's file is those bytes."""
    tree = fenet_run["arrays"]
    want = flax.serialization.to_bytes(tree)
    assert flax_msgpack.dumps(flax.serialization.to_state_dict(tree)) == want
    assert Path(fenet_run["path"]).read_bytes() == want


def test_loads_is_msgpack_restore(fenet_run):
    """float32 arrays and the int32 step count, leaf for leaf, bit for bit,
    from bytes and from the mapped file."""
    blob = Path(fenet_run["path"]).read_bytes()
    want = flax.serialization.msgpack_restore(blob)
    _assert_trees_equal(flax_msgpack.loads(blob), want)
    _assert_trees_equal(flax_msgpack.load(fenet_run["path"]), want)
    count = want["opt_state"]["1"]["count"]
    assert count.dtype == np.int32 and count.shape == () and int(count) == 1


def test_bfloat16_and_scalars_round_trip():
    """bfloat16 leaves as torch.bfloat16, numpy scalars (ExtType 3) and the
    Python scalars, both ways."""
    rng = np.random.RandomState(0)
    tree = _sorted({"w": jnp.asarray(rng.randn(3, 5), jnp.bfloat16),
                    "count": np.int32(7), "x": np.float32(-2.5), "flag": True, "none": None,
                    "i": -300, "f": 0.1, "s": "name" * 10, "empty": {},
                    "z": np.zeros((0, 4), np.float32)})
    blob = flax.serialization.to_bytes(tree)
    got = flax_msgpack.loads(blob)
    _assert_trees_equal(got, flax.serialization.msgpack_restore(blob))
    assert flax_msgpack.dumps(got) == blob


def test_chunked_arrays_read_and_write(fenet_run, monkeypatch):
    """With flax's MAX_CHUNK_SIZE set small, every array above it becomes a
    chunk map; the port reads it back whole and writes the same bytes."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 4096)
    tree = flax.serialization.to_state_dict(fenet_run["arrays"])
    blob = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    _assert_trees_equal(flax_msgpack.loads(blob), flax.serialization.msgpack_restore(blob))
    assert flax_msgpack.dumps(tree) == blob


def test_malformed_streams_raise(tmp_path):
    blob = flax_msgpack.dumps({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(blob[:-3])
    with pytest.raises(ValueError, match="after"):
        flax_msgpack.loads(blob + b"\xc0")
    with pytest.raises(ValueError, match="complex"):
        flax_msgpack.loads(flax.serialization.msgpack_serialize({"c": 1 + 2j}))
    (tmp_path / "empty.ckpt").write_bytes(b"")
    with pytest.raises(ValueError, match="empty"):
        flax_msgpack.load(str(tmp_path / "empty.ckpt"))


# -- (b) training checkpoints in both directions ------------------------------

def test_port_reads_fenets_checkpoint(fenet_run):
    """fenet's file -> the port's blob: the state_dict, both Adam moments
    and the step, bit for bit, and the sidecar's scalars."""
    blob = checkpoint.load_checkpoint(fenet_run["path"])
    arrays = fenet_run["arrays"]
    want = state_dict_from_jax(arrays)
    assert set(blob["state_dict"]) == set(want)
    for key, value in want.items():
        assert torch.equal(blob["state_dict"][key], value), key
    adam = arrays["opt_state"][1]
    mu, nu = (state_dict_from_jax({"params": m}) for m in (adam.mu, adam.nu))
    names = param_names(want)
    assert blob["optimizer"]["param_groups"] == [{"params": list(range(len(names)))}]
    for i, name in enumerate(names):
        entry = blob["optimizer"]["state"][i]
        assert torch.equal(entry["exp_avg"], mu[name]) and torch.equal(entry["exp_avg_sq"],
                                                                         nu[name]), name
        assert entry["step"].dtype == torch.float32 and float(entry["step"]) == 1.0
    meta = {k: v for k, v in blob.items() if k not in ("state_dict", "optimizer")}
    assert json.dumps(meta) == json.dumps(fenet_run["meta"])


def test_fenet_reads_the_ports_checkpoint(fenet_run, tmp_path):
    """The port's save of the blob it read from fenet's file: the same
    bytes and sidecar as fenet's, and fenet's load_checkpoint with a target
    restores the arrays bit for bit; the best copy too."""
    blob = checkpoint.load_checkpoint(fenet_run["path"])
    path = checkpoint.save_checkpoint(blob, True, CAT, str(tmp_path), 1, fmt="flax")
    assert Path(path).name == f"{CAT}_checkpoint_1.ckpt"
    assert Path(path).read_bytes() == Path(fenet_run["path"]).read_bytes()
    assert (Path(path + ".json").read_text()
            == Path(fenet_run["path"] + ".json").read_text())
    state = fenet_run["state"]
    target = {"params": state.params, "batch_stats": state.batch_stats,
              "opt_state": state.opt_state}
    for name in (path, str(tmp_path / "model_best.ckpt")):
        got = jax_load_checkpoint(name, target=target)
        for a, b in zip(jax.tree_util.tree_leaves({k: got[k] for k in target}),
                        jax.tree_util.tree_leaves(fenet_run["arrays"])):
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert json.dumps({k: got[k] for k in fenet_run["meta"]}) == json.dumps(
            fenet_run["meta"])


def test_the_ports_training_state_round_trips(tmp_path):
    """A port Adam state: the .ckpt loads back to the .pth.tar's tensors bit
    for bit (num_batches_tracked, which fenet does not keep, aside)."""
    gen = init_random_(Generator(num_points=N_POINTS, **SMALL), torch.Generator().manual_seed(3))
    names = param_names(gen.state_dict())
    optimizer = {"state": {i: {"step": torch.tensor(4.0),
                               "exp_avg": torch.randn_like(p), "exp_avg_sq": torch.rand_like(p)}
                           for i, (_, p) in enumerate(gen.named_parameters())},
                 "param_groups": [{"params": list(range(len(names))), "lr": 1e-4}]}
    state = {"state_dict": gen.state_dict(), "optimizer": optimizer, "epoch": 4,
             "model_name": "m", "train_time": 2.0, "best_chamfer_loss": 0.5,
             "best_emd_loss": 0.75}
    a = checkpoint.load_checkpoint(checkpoint.save_checkpoint(state, False, "c", str(tmp_path),
                                                              4, fmt="torch"))
    b = checkpoint.load_checkpoint(checkpoint.save_checkpoint(state, False, "c", str(tmp_path),
                                                              4, fmt="flax"))
    assert set(a["state_dict"]) - set(b["state_dict"]) == {
        k for k in a["state_dict"] if k.endswith("num_batches_tracked")}
    for key, value in b["state_dict"].items():
        assert torch.equal(value, a["state_dict"][key]), key
    for i, entry in a["optimizer"]["state"].items():
        for key, value in entry.items():
            assert torch.equal(b["optimizer"]["state"][i][key], value), (i, key)
    assert {k: v for k, v in b.items() if k not in ("state_dict", "optimizer")} == {
        k: v for k, v in state.items() if k not in ("state_dict", "optimizer")}


def _tiny_state(value: float, epoch: int):
    """A SimpleGenerator-shaped state with one tiny head: enough for the
    containers, a few hundred bytes."""
    return {"state_dict": {"fc1.weight": torch.full((2, 3), value), "fc1.bias": torch.zeros(2)},
            "optimizer": {"state": {}, "param_groups": [{"params": [0, 1]}]},
            "epoch": epoch}


def test_resume_picks_the_newest_in_either_container(tmp_path):
    """Highest epoch wins across containers (periodic over an older best);
    at equal epochs the configured container's model_best."""
    import logging

    logger = logging.getLogger("test")
    d = str(tmp_path)
    checkpoint.save_checkpoint(_tiny_state(1.0, 2), True, "c", d, 2, fmt="torch")
    checkpoint.save_checkpoint(_tiny_state(2.0, 2), True, "c", d, 2, fmt="flax")
    assert float(_newest_checkpoint(d, "c", "flax", logger)["state_dict"]["fc1.weight"][0, 0]) == 2
    assert float(_newest_checkpoint(d, "c", "torch", logger)["state_dict"]["fc1.weight"][0, 0]) == 1
    checkpoint.save_checkpoint(_tiny_state(3.0, 3), False, "c", d, 3, fmt="flax")
    blob = _newest_checkpoint(d, "c", "torch", logger)
    assert blob["epoch"] == 3 and float(blob["state_dict"]["fc1.weight"][0, 0]) == 3
    # Adam had no state yet: optax's init, count 0 and zero moments.
    assert all(float(e["step"]) == 0 and not e["exp_avg"].any()
               for e in blob["optimizer"]["state"].values())


def test_check_format():
    """The three containers are accepted (fenet's orbax one since it is
    ported, tests/test_torch_checkpoint_orbax.py); any other raises."""
    for fmt in ("torch", "flax", "orbax"):
        checkpoint.check_format(fmt)
    assert checkpoint.SUFFIXES["orbax"] == ".orbax"
    with pytest.raises(ValueError, match="pickle"):
        checkpoint.check_format("pickle")


def test_param_names_follow_registration_order():
    """Adam numbers its state by ``model.parameters()``: the order the
    port derives from a state_dict's names, for every backbone, branched
    and folded, and for the SimpleGenerator."""
    for name in REPVGG_CONFIGS:
        for deploy in (False, True):
            with torch.device("meta"):
                gen = Generator(backbone=name, deploy=deploy)
            assert param_names(gen.state_dict()) == [n for n, _ in gen.named_parameters()]
        with torch.device("meta"):
            simple = SimpleGenerator(backbone=name)
        assert param_names(simple.state_dict()) == [n for n, _ in simple.named_parameters()]


def test_variables_from_state_dict_inverts_fenets_conversion():
    """The port's state_dict -> fenet's tree, against fenet's own
    ``torch_state_dict_to_variables``, bit for bit, keys sorted."""
    gen = init_random_(Generator(num_points=N_POINTS, **SMALL), torch.Generator().manual_seed(4))
    want = torch_state_dict_to_variables(gen.state_dict())
    _assert_trees_equal(variables_from_state_dict(gen.state_dict()), _sorted(want))


# -- (c) resume parity --------------------------------------------------------

def test_resumed_step_matches_fenet(fenet_run, tmp_path):
    """fenet's checkpoint after one step; fenet and the port each resume
    the second step from it."""
    run = fenet_run
    blob = jax_load_checkpoint(run["path"], target={
        "params": run["state"].params, "batch_stats": run["state"].batch_stats,
        "opt_state": run["state"].opt_state})
    state = run["state"].replace(params=blob["params"], batch_stats=blob["batch_stats"],
                                 opt_state=blob["opt_state"])
    state, stats = run["trainer"].train_step(state, jnp.asarray(run["img"]),
                                             jnp.asarray(run["pt"]), 1, run["lr"])
    want_losses = [float(stats[k]) for k in ("total_loss", "chamfer_loss", "emd_loss")]
    np.savez(tmp_path / "in.npz", ckpt=run["path"], img=run["img"], pt=run["pt"], lr=run["lr"],
             assignment=run["assignment"])
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    subprocess.run([sys.executable, __file__, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npz")], check=True, cwd=REPO, env=env, timeout=600)
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    arrays = jax.tree_util.tree_map(np.asarray, {"params": state.params})
    adam = state.opt_state[1]
    assert int(adam.count) == 2 and float(got["step"]) == 2.0
    expected = {"param": state_dict_from_jax(arrays),
                "mu": state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, adam.mu)}),
                "nu": state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, adam.nu)})}
    for kind, want in expected.items():
        for name, value in want.items():
            value = value.numpy()
            if kind == "param":
                rtol, atol = PARAM_RTOL, 2 * run["lr"]
            else:
                rtol, atol = MOMENT_RTOL, MOMENT_ATOL_REL * float(np.abs(value).max())
            np.testing.assert_allclose(got[f"{kind}.{name}"], value, rtol=rtol, atol=atol,
                                       err_msg=f"{kind}.{name}")


# -- (d), (e) a tree holding only fenet's model_best.ckpt -----------------------

@pytest.fixture(scope="module")
def fenet_tree(tmp_path_factory):
    """A synthetic ShapeNet tree whose checkpoint directory holds only
    fenet's ``model_best.ckpt``: the port's init with random BN statistics
    and output heads scaled by 0.3 (the untrained prediction then has about
    the gt's scale, which keeps ICP well-posed), saved by fenet; and fenet's
    float32 and bf16 ``model_deploy.ckpt`` of it, under ``deploy/``."""
    root = tmp_path_factory.mktemp("fenet_tree")
    write_synthetic_shapenet(str(root), cats=(CAT,), models_per_cat=1, num_points=N_POINTS)
    model = JaxGenerator(num_points=N_POINTS, **SMALL)
    variables = _port_init_variables(model, seed=5)
    rng = np.random.RandomState(6)
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.3, x.shape)).astype(np.float32),
        variables["batch_stats"])
    for head in ("fc3_1", "conv2_1", "conv1_3"):
        for leaf in ("kernel", "bias"):
            variables["params"]["decoder"][head][leaf] = \
                variables["params"]["decoder"][head][leaf] * np.float32(0.3)
    ckpt_dir = root / "out" / CAT / "checkpoints"
    jax_save_checkpoint({**variables, "epoch": 10}, True, CAT, str(ckpt_dir), 10, fmt="flax")
    (ckpt_dir / f"{CAT}_checkpoint_10.ckpt").unlink()
    (ckpt_dir / f"{CAT}_checkpoint_10.ckpt.json").unlink()
    deploy = root / "deploy"
    deploy.mkdir()
    for dtype in ("float32", "bfloat16"):
        jax_export_main(["--model", str(ckpt_dir), *ARCH, "--dtype", dtype,
                         "--out", str(deploy / f"fenet_{dtype}.ckpt")])
    yield dict(root=root, ckpt_dir=ckpt_dir, deploy=deploy)
    shutil.rmtree(root, ignore_errors=True)


def test_weight_loading_clis_find_fenets_model_best(fenet_tree):
    """Where there is no model_best.pth.tar, the CLIs that load weights
    (eval_shapenet, eval_pix3d, render, render_pix3d and heatmap through
    ``require_checkpoints``, record_goldens through ``checkpoint_path``)
    take model_best.ckpt, with fenet's weights."""
    import argparse

    from fenet_torch.cli import common, record_goldens, render

    pattern = str(fenet_tree["root"] / "out" / "%s" / "checkpoints")
    want = str(fenet_tree["ckpt_dir"] / "model_best.ckpt")
    parser = argparse.ArgumentParser()
    assert common.require_checkpoints(parser, pattern, [CAT]) == {CAT: want}
    assert record_goldens.checkpoint_path(argparse.Namespace(torch_model=None, model=pattern),
                                          CAT) == want
    opt = argparse.Namespace(model=pattern, num_points=N_POINTS, **SMALL)
    gen = render.load_generator(parser, opt, CAT, "cpu")
    fenet_blob = jax_load_checkpoint(want)
    for key, value in state_dict_from_jax(fenet_blob).items():
        assert torch.equal(gen.state_dict()[key], value), key
    with pytest.raises(SystemExit):
        common.require_checkpoints(parser, pattern, ["absent"])


def test_train_cli_resumes_fenets_run(fenet_run, tmp_path):
    """fenet's epoch-1 checkpoint (with its Adam state) in a training tree:
    the port's train CLI resumes it at epoch 2 in the flax container, and
    fenet reads what it wrote, Adam's count one step on."""
    write_synthetic_shapenet(str(tmp_path), cats=(CAT,), models_per_cat=1,
                             num_points=N_POINTS)
    ckpt_dir = tmp_path / "out" / CAT / "checkpoints"
    ckpt_dir.mkdir(parents=True)
    for name in os.listdir(fenet_run["ckpt_dir"]):
        shutil.copyfile(fenet_run["ckpt_dir"] / name, ckpt_dir / name)
    args = [sys.executable, "-m", "fenet_torch.cli.train", "--device", "cpu", "--cats", CAT,
            "--batchSize", "24", *ARCH, "--emd_iters", "50", "--validate_epochs", "2",
            "--nepoch", "2", "--resume", "True", "--ckpt_format", "flax",
            "--dir_path", str(tmp_path / "out"), "--splits_path", str(tmp_path / "splits"),
            "--data_dir_imgs", str(tmp_path / "ShapeNetRendering"),
            "--data_dir_pcl", str(tmp_path / "ShapeNet_pointclouds")]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    subprocess.run(args, check=True, cwd=REPO, env=env, timeout=600, capture_output=True)
    path = ckpt_dir / f"{CAT}_checkpoint_2.ckpt"
    state = fenet_run["state"]
    got = jax_load_checkpoint(str(path), target={
        "params": state.params, "batch_stats": state.batch_stats, "opt_state": state.opt_state})
    assert int(got["opt_state"][1].count) == 2  # one batch of 24 views a epoch
    assert got["epoch"] == 2 and got["train_time"] > fenet_run["meta"]["train_time"]
    assert got["model_name"] == str(ckpt_dir)
    assert not list(ckpt_dir.glob("*.pth.tar"))
    log = (ckpt_dir / "logging.log").read_text()
    assert log.count("[Epoch 1/") == 0 and log.count("[Epoch 2/2]") == 1


def test_eval_shapenet_reads_fenets_model_best(fenet_tree):
    """The port's eval CLI against fenet's on the same tree and file."""
    root = fenet_tree["root"]
    assert sorted(os.listdir(fenet_tree["ckpt_dir"])) == ["model_best.ckpt",
                                                          "model_best.ckpt.json"]
    args = [*ARCH, "--batchSize", "8", "--cats", CAT,
            "--model", str(root / "out" / "%s" / "checkpoints"),
            "--splits_path", str(root / "splits"),
            "--data_dir_imgs", str(root / "ShapeNetRendering"),
            "--data_dir_pcl", str(root / "ShapeNet_pointclouds")]
    want = jax_eval_main(args)[CAT]
    got = eval_shapenet.main(args + ["--device", "cpu"])[CAT]
    assert got["samples"] == want["samples"] > 0
    np.testing.assert_allclose(got["ChamferDistance"], want["ChamferDistance"], rtol=CD_RTOL)
    np.testing.assert_allclose(got["EMD_distance"], want["EMD_distance"], rtol=EMD_RTOL)


def _deploy_forward(path, images):
    gen, variables, dtype = jax_load_deploy(str(path))
    return np.asarray(gen.apply(variables, jnp.asarray(images, dtype))[2], np.float32)


def test_export_deploy_reads_fenets_model_best(fenet_tree, tmp_path):
    """The port's export_deploy --format flax from fenet's model_best.ckpt:
    fenet's sidecar, and fenet's loader serves it as it serves fenet's own
    export of the same file."""
    out = export_deploy.main(["--model", str(fenet_tree["root"] / "out" / "%s" / "checkpoints"),
                              "--category", CAT, *ARCH, "--device", "cpu", "--format", "flax",
                              "--out", str(tmp_path / "port_float32.ckpt")])
    with open(out + ".json") as f:
        meta = json.load(f)
    with open(fenet_tree["deploy"] / "fenet_float32.ckpt.json") as f:
        want = json.load(f)
    assert list(meta) == list(want)
    assert {k: meta[k] for k in meta if k != "source"} == {k: want[k] for k in want
                                                           if k != "source"}
    images = np.random.RandomState(7).randint(0, 256, (3, 128, 128, 3)).astype(np.float32)
    np.testing.assert_allclose(_deploy_forward(out, images),
                               _deploy_forward(fenet_tree["deploy"] / "fenet_float32.ckpt",
                                               images), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_predict_serves_fenets_model_deploy(fenet_tree, tmp_path, dtype):
    """Both predict CLIs on fenet's model_deploy.ckpt and the same PNGs."""
    import cv2

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i, side in enumerate((137, 128, 96)):
        cv2.imwrite(str(imgs / f"view{i}.png"),
                    np.random.RandomState(10 + i).randint(0, 256, (side, side, 3), np.uint8))
    deploy = str(fenet_tree["deploy"] / f"fenet_{dtype}.ckpt")
    common = ["--images", str(imgs), "--batchSize", "2", "--ply_binary"]
    want = jax_predict_main(["--deploy_ckpt", deploy, "--out_dir", str(tmp_path / "fenet"),
                             *common])
    got = predict.main(["--deploy_ckpt", deploy, "--out_dir", str(tmp_path / "port"),
                        "--device", "cpu", *common])
    names = sorted(Path(p).name for p in got)
    assert names == sorted(Path(p).name for p in want) and len(names) == 3
    for name in names:
        a = load_pointcloud(str(tmp_path / "port" / name))
        b = load_pointcloud(str(tmp_path / "fenet" / name))
        assert a.shape == (N_POINTS, 3) and np.isfinite(a).all()
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)
        else:
            assert float(np.abs(a - b).max() / np.abs(b).max()) < BF16_REL, name


def test_load_deploy_checkpoint_keeps_fenets_bf16(fenet_tree):
    """A bf16 model_deploy.ckpt loads as bf16 weights equal to fenet's,
    bit for bit."""
    model, dtype = export_deploy.load_deploy_checkpoint(
        str(fenet_tree["deploy"] / "fenet_bfloat16.ckpt"), "cpu")
    assert dtype == torch.bfloat16 and model.deploy
    _, variables, _ = jax_load_deploy(str(fenet_tree["deploy"] / "fenet_bfloat16.ckpt"))
    want = state_dict_from_jax({"params": jax.tree_util.tree_map(
        lambda x: torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16),
        variables["params"])})
    got = model.state_dict()
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == torch.bfloat16 and torch.equal(got[key], value), key


# -- (f) no flax, msgpack, JAX or fenet ---------------------------------------

def test_port_runs_with_flax_msgpack_jax_and_fenet_blocked(tmp_path):
    """A process where those packages cannot be imported imports every
    fenet_torch module and chip_smoke.py, and round-trips a checkpoint and a
    deploy file through the flax container."""
    code = f"""
import sys
for name in ("msgpack", "flax", "jax", "jaxlib", "optax", "fenet", "ml_dtypes"):
    sys.modules[name] = None
import importlib, json, pkgutil
import torch
import fenet_torch
for m in pkgutil.walk_packages(fenet_torch.__path__, "fenet_torch."):
    importlib.import_module(m.name)
import chip_smoke
from fenet_torch.models.generator import Generator, init_random_
from fenet_torch.train import checkpoint
gen = init_random_(Generator(num_points=256, backbone="RepVGG-TEST", fine_width=32,
                             mid_width=16), torch.Generator().manual_seed(0))
state = {{"state_dict": gen.state_dict(), "epoch": 1}}
path = checkpoint.save_checkpoint(state, True, "c", {str(tmp_path)!r}, 1, fmt="flax")
blob = checkpoint.load_checkpoint({str(tmp_path / "model_best.ckpt")!r})
assert blob["epoch"] == 1 and "optimizer" not in blob
for k, v in blob["state_dict"].items():
    assert torch.equal(v, gen.state_dict()[k]), k
bad = sorted(n for n in sys.modules if sys.modules[n] is not None
             and n.split(".")[0] in ("msgpack", "flax", "jax", "optax", "fenet"))
assert not bad, bad
print("ok", len([n for n in sys.modules if n.startswith("fenet_torch")]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2] == "ok" and int(out.stdout.split()[-1]) >= 20


# -- the small helpers of fenet -------------------------------------------------

class _Meter:
    def __init__(self, text):
        self.text = text

    def __str__(self):
        return self.text


def test_progress_meter_and_accuracy_match_fenet(capsys):
    meters = [_Meter("Loss 0.5"), _Meter("Time 1.25")]
    average_meter.ProgressMeter(120, meters, prefix="Epoch: [3]").display(7)
    ours = capsys.readouterr().out
    jax_average_meter.ProgressMeter(120, meters, prefix="Epoch: [3]").display(7)
    assert ours == capsys.readouterr().out == "Epoch: [3][  7/120]\tLoss 0.5\tTime 1.25\n"
    rng = np.random.RandomState(0)
    scores = rng.randn(16, 10).astype(np.float32)
    scores[3, 4] = scores[3, 5] = 9.0  # a tie at the top
    target = rng.randint(0, 10, 16)
    want = jax_average_meter.accuracy(scores, target, topk=(1, 3, 5))
    assert average_meter.accuracy(scores, target, topk=(1, 3, 5)) == want
    assert average_meter.accuracy(torch.tensor(scores), torch.tensor(target), (1, 3, 5)) == want


@pytest.mark.parametrize("deploy", [False, True])
def test_create_repvgg_matches_fenet(deploy):
    """The same modules and shapes as fenet's ``create_repvgg``, and the same
    features from the same weights."""
    ours = create_repvgg("RepVGG-TEST", deploy=deploy)
    theirs = jax_create_repvgg("RepVGG-TEST", deploy=deploy)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, theirs.init(jax.random.PRNGKey(0), x))
    sd = state_dict_from_jax({col: {"RepVGG": v} for col, v in variables.items()})
    sd = {k[len("RepVGG."):]: v for k, v in sd.items()}
    assert {k for k in ours.state_dict() if not k.endswith("num_batches_tracked")} == set(sd)
    ours.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = ours.eval()(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(theirs.apply(variables, x)),
                               rtol=RTOL, atol=ATOL)


def test_transpose_clouds_and_chamfer_ref_match_fenet():
    rng = np.random.RandomState(2)
    a = rng.rand(2, 40, 3).astype(np.float32)
    b = rng.rand(2, 50, 3).astype(np.float32)
    np.testing.assert_array_equal(transpose_clouds(torch.tensor(a)).numpy(),
                                  np.asarray(jax_transpose_clouds(jnp.asarray(a))))
    got = transpose_clouds(torch.tensor(a), torch.tensor(b))
    want = jax_transpose_clouds(jnp.asarray(a), jnp.asarray(b))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Dyadic coordinates: every squared distance is exact in both.
    a, b = np.round(a * 64) / 64, np.round(b * 64) / 64
    got = chamfer_distance_ref(torch.tensor(a), torch.tensor(b))
    want = jax_chamfer_distance_ref(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        assert g.dtype == (torch.int32 if np.asarray(w).dtype == np.int32 else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
