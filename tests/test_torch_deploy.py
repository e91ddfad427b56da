"""The deploy fold of fenet_torch against fenet's: the folded state_dict, the
deploy forward, the bf16 cast, grouped and SE blocks against the port's own
branched forward, and ``--deploy`` in the two eval CLIs (forward only, one
process; data crosses between the frameworks as numpy arrays).

fenet's ``fold_generator_params`` passes no group counts, so it cannot fold
a grouped backbone (its identity kernel has the ungrouped shape); the port
reads each block's groups from its own conv, and grouped folds are held
against the port's branched forward instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenet.models.generator import Generator as JaxGenerator
from fenet.models.generator import fold_generator_params as jax_fold_generator_params
from fenet.models.generator import init_variables
from fenet.models.generator import to_deploy as jax_to_deploy
from fenet_torch.cli import eval_pix3d, eval_shapenet
from fenet_torch.data.synthetic import write_synthetic_pix3d, write_synthetic_shapenet
from fenet_torch.models.convert import state_dict_from_jax
from fenet_torch.models.generator import (
    Generator,
    fold_generator_params,
    init_random_,
    to_deploy,
)
from fenet_torch.models.repvgg import RepVGG, RepVGGConfig, fold_repvgg_params
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

SMALL = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
RTOL, ATOL = 1e-4, 1e-3  # port against fenet, as tests/test_torch_models.py
FOLD_TOL = 1e-3  # folded against branched, fenet's tests/test_deploy.py
BF16_REL = 0.05  # bf16 against float32 fold, of max|ref|: fenet's test_extras.py
CD_RTOL, EMD_RTOL = 1e-5, 5e-2  # the eval CLIs, as tests/test_torch_eval.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize_stats(batch_stats, rng):
    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, batch_stats)


def _randomize_bn_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Random BN affine and running statistics, so the fold is no identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model


def _images(seed, b=2):
    return np.random.RandomState(seed).randint(0, 256, (b, 128, 128, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def fenet_small():
    model = JaxGenerator(num_points=256, **SMALL)
    v = jax.tree_util.tree_map(np.asarray, init_variables(
        model, np.zeros((1, 128, 128, 3), np.float32), rng=jax.random.PRNGKey(5)))
    return model, {"params": v["params"],
                   "batch_stats": _randomize_stats(v["batch_stats"], np.random.RandomState(0))}


def _branched(variables):
    gen = Generator(num_points=256, **SMALL)
    gen.load_state_dict(state_dict_from_jax(variables), strict=True)
    return gen.eval()


def test_fold_matches_fenet(fenet_small):
    """(a) The port's fold of the converted branched weights equals fenet's
    fold, converted."""
    _, variables = fenet_small
    ours = fold_generator_params(state_dict_from_jax(variables))
    folded = jax.tree_util.tree_map(
        np.asarray, jax_fold_generator_params(variables["params"], variables["batch_stats"]))
    ref = state_dict_from_jax({"params": folded})
    assert set(ours) == set(ref)
    assert any(k.endswith("rbr_reparam.weight") for k in ref) and "edge0.0.bias" in ref
    for key, value in ref.items():
        np.testing.assert_allclose(ours[key].numpy(), value.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=key)
    # fenet's folded params load into the port's deploy module as they are.
    Generator(num_points=256, deploy=True, **SMALL).load_state_dict(ref, strict=True)


def test_deploy_forward_matches_fenet(fenet_small):
    """(b) ``to_deploy`` and the deploy forward against fenet's."""
    model, variables = fenet_small
    dmodel, dvars = jax_to_deploy(model, variables)
    images = _images(1)
    want = dmodel.apply(dvars, jnp.asarray(images, jnp.float32), train=False)
    deploy = to_deploy(_branched(variables))
    assert deploy.deploy and not deploy.training
    with torch.inference_mode():
        got = deploy(torch.tensor(images))
    for g, w, n in zip(got, want, (128, 256, 256)):
        assert tuple(g.shape) == (2, n, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_deploy_forward_matches_branched(fenet_small):
    """(c) The port's folded forward against its own branched eval forward."""
    _, variables = fenet_small
    gen = _branched(variables)
    images = torch.tensor(_images(2))
    with torch.inference_mode():
        want = gen(images)
        got = to_deploy(gen)(images)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=FOLD_TOL, atol=FOLD_TOL)


@pytest.mark.parametrize("groups,use_se", [(2, False), (4, True)])
def test_grouped_fold_matches_branched(groups, use_se):
    """(d) Grouped blocks, with an identity branch (stage2's second block)
    and optionally the SE gate: the fold reads groups from each block's
    conv."""
    config = RepVGGConfig([1, 2, 2, 1], [0.5, 0.5, 0.5, 0.5],
                          {2: groups, 3: groups, 5: groups}, use_se=use_se, num_classes=10)
    torch.manual_seed(3)
    branched = _randomize_bn_(RepVGG(config), 4).eval()
    deploy = RepVGG(config, deploy=True)
    deploy.load_state_dict(fold_repvgg_params(branched.state_dict()), strict=True)
    assert deploy.stage2[1].rbr_reparam.groups == groups
    x = torch.tensor(np.random.RandomState(5).rand(2, 3, 64, 64).astype(np.float32) * 255)
    with torch.inference_mode():
        want, got = branched(x), deploy.eval()(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=FOLD_TOL, atol=FOLD_TOL)


def test_bf16_fold_against_float32(fenet_small):
    """(e) The bf16 fold computes in bf16 end to end (parameters, the edge
    kernel, the clouds) within 5% of max|ref| of the float32 fold."""
    _, variables = fenet_small
    gen = _branched(variables)
    images = torch.tensor(_images(3))
    bf16 = to_deploy(gen, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf16.parameters())
    assert bf16.edge_kernel.dtype == torch.bfloat16
    with torch.inference_mode():
        ref = to_deploy(gen)(images)[2]
        got = bf16(images)[2]
    assert got.dtype == torch.bfloat16
    got = got.float()
    assert torch.isfinite(got).all()
    assert float((got - ref).abs().max() / ref.abs().max()) < BF16_REL


def _port_checkpoint(path, num_points):
    """A branched model with random BN statistics and output heads scaled by
    0.3, so the untrained prediction has about the gt's scale (ICP of a cloud
    ~30x or ~1/100 of the gt's size onto it is ill-posed: 1e-9 in the
    prediction moved the aligned cloud by 1e-2), saved as the reference's
    container."""
    gen = _randomize_bn_(init_random_(Generator(num_points=num_points, **SMALL),
                                      torch.Generator().manual_seed(0)), 1)
    with torch.no_grad():
        for layer in (gen.fc3_1, gen.conv2_1, gen.conv1_3):
            layer.weight.mul_(0.3)
            layer.bias.mul_(0.3)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": gen.state_dict()}, path)


def _assert_summaries_close(got, want):
    assert set(got) == set(want)
    for cat in got:
        assert got[cat]["samples"] == want[cat]["samples"] > 0
        np.testing.assert_allclose(got[cat]["ChamferDistance"], want[cat]["ChamferDistance"],
                                   rtol=CD_RTOL)
        np.testing.assert_allclose(got[cat]["EMD_distance"], want[cat]["EMD_distance"],
                                   rtol=EMD_RTOL)


def test_eval_shapenet_deploy(tmp_path):
    """(f) ``eval_shapenet --deploy`` against the same CLI without it."""
    n, cat = 256, "02691156"
    write_synthetic_shapenet(str(tmp_path), cats=(cat,), models_per_cat=1, num_points=n)
    _port_checkpoint(tmp_path / "out" / cat / "checkpoints" / "model_best.pth.tar", n)
    args = ["--device", "cpu", "--batchSize", "8", "--num_points", str(n),
            "--backbone", SMALL["backbone"], "--fine_width", "32", "--mid_width", "16",
            "--cats", cat, "--model", str(tmp_path / "out" / "%s" / "checkpoints"),
            "--splits_path", str(tmp_path / "splits"),
            "--data_dir_imgs", str(tmp_path / "ShapeNetRendering"),
            "--data_dir_pcl", str(tmp_path / "ShapeNet_pointclouds")]
    _assert_summaries_close(eval_shapenet.main(args + ["--deploy"]), eval_shapenet.main(args))


def test_eval_pix3d_deploy(tmp_path):
    """(f) ``eval_pix3d --deploy`` against the same CLI without it."""
    n = 256
    root = tmp_path / "pix3d"
    write_synthetic_pix3d(str(root), cats=("chair",), samples_per_cat=3, num_points=n, seed=2)
    _port_checkpoint(tmp_path / "out" / eval_pix3d.PIX3D_TO_SHAPENET["chair"] / "checkpoints"
                     / "model_best.pth.tar", n)
    args = ["--device", "cpu", "--batchSize", "2", "--num_points", str(n),
            "--backbone", SMALL["backbone"], "--fine_width", "32", "--mid_width", "16",
            "--cats", "chair", "--data_dir", str(root),
            "--model", str(tmp_path / "out" / "%s" / "checkpoints")]
    _assert_summaries_close(eval_pix3d.main(args + ["--deploy"]), eval_pix3d.main(args))


@pytest.mark.parametrize("cli", [eval_shapenet, eval_pix3d])
def test_eval_cli_missing_checkpoint_is_a_usage_error(cli, tmp_path):
    """A category without its checkpoint stops the CLI before any data is
    read or any directory is made."""
    with pytest.raises(SystemExit):
        cli.main(["--device", "cpu", "--deploy", "--model", str(tmp_path / "none" / "%s")])
    assert not (tmp_path / "none").exists()
