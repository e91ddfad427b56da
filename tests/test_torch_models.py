"""fenet_torch.models against fenet.models: the same JAX variables, carried
into the port by ``state_dict_from_jax``, must give the same outputs.

Both frameworks run in this process, forward only; data crosses between
them as numpy arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fenet.models.generator import Generator as JaxGenerator
from fenet.models.generator import init_variables
from fenet.models.repvgg import REPVGG_CONFIGS as JAX_CONFIGS
from fenet.models.repvgg import RepVGG as JaxRepVGG
from fenet.models.repvgg import RepVGGBlock as JaxBlock
from fenet.train.checkpoint import export_torch_checkpoint, variables_to_torch_state_dict
from fenet_torch.models.convert import load_reference_checkpoint, state_dict_from_jax
from fenet_torch.models.generator import Generator, init_random_
from fenet_torch.models.repvgg import REPVGG_CONFIGS, RepVGGBlock, _stage_plan
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

# float32 on both sides; the two convolution libraries sum in different
# orders, which over the backbone's depth moves outputs of magnitude ~250
# by ~2e-4.
RTOL, ATOL = 1e-4, 1e-3
SMALL = dict(num_points=1024, backbone="RepVGG-TEST", fine_width=32, mid_width=16)


def _randomize_stats(batch_stats, rng):
    """Random BN statistics, so their conversion is actually exercised."""
    def draw(path, x):
        if path[-1].key == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        return rng.normal(0.0, 0.5, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, batch_stats)


@pytest.fixture(scope="module")
def jax_small():
    model = JaxGenerator(**SMALL)
    v = init_variables(model, np.zeros((1, 128, 128, 3), np.float32),
                       rng=jax.random.PRNGKey(3))
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(0)
    return model, {"params": v["params"],
                   "batch_stats": _randomize_stats(v["batch_stats"], rng)}


def test_generator_matches_fenet(jax_small):
    model, variables = jax_small
    gen = Generator(**SMALL)
    gen.load_state_dict(state_dict_from_jax(variables), strict=True)
    gen.eval()
    images = np.random.RandomState(1).randint(0, 256, (2, 128, 128, 3)).astype(np.uint8)
    want = model.apply(variables, jnp.asarray(images, jnp.float32), train=False)
    with torch.inference_mode():
        got = gen(torch.tensor(images))
    for g, w, n in zip(got, want, (128, 256, 1024)):
        assert tuple(g.shape) == (2, n, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_state_dict_matches_fenet_export(jax_small):
    _, variables = jax_small
    ours = state_dict_from_jax(variables)
    ref = variables_to_torch_state_dict(variables)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    # The port's own module tree has exactly these names (BatchNorm's
    # num_batches_tracked counters aside).
    names = {k for k in Generator(**SMALL).state_dict()
             if not k.endswith("num_batches_tracked")}
    assert names == set(ref)


def test_reference_checkpoint_loads_strict(jax_small, tmp_path):
    _, variables = jax_small
    path = tmp_path / "model_best.pth.tar"
    export_torch_checkpoint(variables, str(path), extra={"epoch": 10})
    gen = load_reference_checkpoint(Generator(**SMALL), str(path))
    for key, value in state_dict_from_jax(variables).items():
        assert torch.equal(gen.state_dict()[key], value), key


@pytest.mark.parametrize("name", sorted(REPVGG_CONFIGS))
def test_stage_plan_matches_fenet(name):
    assert _stage_plan(REPVGG_CONFIGS[name]) == JaxRepVGG(config=JAX_CONFIGS[name])._stage_plan()


@pytest.mark.parametrize("groups,use_se", [(2, False), (1, True)])
def test_repvgg_block_matches_fenet(groups, use_se):
    """Grouped convs and the SE gate, which RepVGG-TEST does not use."""
    block = JaxBlock(32, groups=groups, use_se=use_se)
    x = np.random.RandomState(2).randn(2, 8, 8, 32).astype(np.float32)
    v = jax.tree_util.tree_map(
        np.asarray, block.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    v = {"params": v["params"],
         "batch_stats": _randomize_stats(v["batch_stats"], np.random.RandomState(3))}
    want = block.apply(v, jnp.asarray(x))
    wrapped = {k: {"RepVGG": {"stage1_0": v[k]}} for k in v}
    sd = {k[len("RepVGG.stage1.0."):]: t for k, t in state_dict_from_jax(wrapped).items()}
    ours = RepVGGBlock(32, 32, 1, groups, use_se)
    ours.load_state_dict(sd, strict=True)
    with torch.inference_mode():
        got = ours.eval()(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_init_random_is_seeded():
    def make(seed):
        gen = Generator(**SMALL)
        return init_random_(gen, torch.Generator().manual_seed(seed)).state_dict()
    a, b, c = make(0), make(0), make(1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc1.weight"], c["fc1.weight"])
    assert torch.equal(a["RepVGG.stage0.rbr_dense.bn.running_var"],
                       torch.ones_like(a["RepVGG.stage0.rbr_dense.bn.running_var"]))


def test_generator_takes_float_and_uint8_alike():
    gen = init_random_(Generator(**SMALL), torch.Generator().manual_seed(0)).eval()
    images = np.random.RandomState(4).randint(0, 256, (1, 128, 128, 3))
    with torch.inference_mode():
        a = gen(torch.tensor(images.astype(np.uint8)))[2]
        b = gen(torch.tensor(images.astype(np.float32)))[2]
    assert torch.equal(a, b) and torch.isfinite(a).all()
