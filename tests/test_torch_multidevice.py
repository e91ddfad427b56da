"""Serving over several devices in fenet_torch against fenet's: the
deploy forward built from a folded checkpoint and from an artifact, with
the batch rounded up to the device count and split into one shard a
device, against fenet's forwards over its 8 host devices
(``tests/conftest.py``); the MicroBatcher, the HTTP server and the predict
CLI on a split forward against the one-device forward.

On the CPU the devices are ``["cpu"] * n``: n replicas, each on its shard.
Tolerances: against fenet the deploy tolerance (rtol 1e-4, atol 1e-3,
``tests/test_torch_serve.py``); a split forward against the one-device
forward 1e-5 of max|ref| (the same weights on smaller batches; CPU
convolutions may sum in another order at another batch).

Tests marked ``gpu`` skip without a card. On the card, which has no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_multidevice.py``.
"""

import json
import shutil
import threading
import urllib.request

import numpy as np
import pytest
import torch

try:
    import jax

    from fenet.cli.export_deploy import main as jax_export_main
    from fenet.models.generator import Generator as JaxGenerator
    from fenet.models.generator import init_variables
    from fenet.serve.artifact import build_forward_artifact as jax_build_forward_artifact
    from fenet.serve.server import build_forward as jax_build_forward
    from fenet.train.checkpoint import export_torch_checkpoint, save_checkpoint
except ImportError:
    # The card machine has no JAX; there only the gpu tests run.
    pass
from fenet_torch.cli import export_deploy, predict
from fenet_torch.models.generator import Generator, init_random_, to_deploy
from fenet_torch.serve import artifact, server
from fenet_torch.serve.artifact import build_forward_artifact
from fenet_torch.serve.batcher import MicroBatcher, fetch
from fenet_torch.serve.server import (
    build_forward,
    device_forward,
    make_server,
    round_batch,
    serving_devices,
)
from fenet_torch.utils.ply import load_pointcloud
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

SMALL = dict(num_points=256, backbone="RepVGG-TEST", fine_width=32, mid_width=16)
ARCH = ["--backbone", "RepVGG-TEST", "--num_points", "256", "--fine_width", "32",
        "--mid_width", "16"]
RTOL, ATOL = 1e-4, 1e-3  # port against fenet, float32 (tests/test_torch_serve.py)
SPLIT_REL = 1e-5  # a split forward against the one-device forward, of max|ref|
HOST_DEVICES = 8  # fenet's host devices in the tests (tests/conftest.py)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _images(seed, b):
    return np.random.RandomState(seed).randint(0, 256, (b, 128, 128, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def deploy_files(tmp_path_factory):
    """One small generator's weights (random BN statistics) through both
    packages' export_deploy, in both containers, float32: {(package,
    container): path}. Deleted after the module's tests."""
    root = tmp_path_factory.mktemp("multidevice")
    model = JaxGenerator(**SMALL)
    v = jax.tree_util.tree_map(np.asarray, init_variables(
        model, np.zeros((1, 128, 128, 3), np.float32), rng=jax.random.PRNGKey(3)))
    rng = np.random.RandomState(8)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.3, x.shape)).astype(np.float32),
        v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    ckpt = root / "ckpt"
    save_checkpoint({**v, "epoch": 1}, True, "t", str(ckpt), 1)
    export_torch_checkpoint(v, str(ckpt / "model_best.pth.tar"))
    files = {
        ("fenet", "checkpoint"): jax_export_main(
            ["--model", str(ckpt), *ARCH, "--out", str(root / "fenet_deploy.ckpt")]),
        ("fenet", "artifact"): jax_export_main(
            ["--model", str(ckpt), *ARCH, "--format", "stablehlo", "--platforms", "cpu",
             "--out", str(root / "fenet_deploy.stablehlo")]),
        ("port", "checkpoint"): export_deploy.main(
            ["--model", str(ckpt), *ARCH, "--device", "cpu", "--out",
             str(root / "port_deploy.pth")]),
        ("port", "artifact"): export_deploy.main(
            ["--model", str(ckpt), *ARCH, "--device", "cpu", "--format", "export",
             "--out", str(root / "port_deploy.pt2")]),
    }
    yield files
    shutil.rmtree(root, ignore_errors=True)


def _fenet_forward(files, container, max_batch):
    if container == "checkpoint":
        return jax_build_forward(files["fenet", "checkpoint"], max_batch)
    return jax_build_forward_artifact(files["fenet", "artifact"], max_batch)


def _port_forward(files, container, max_batch, devices):
    build = build_forward if container == "checkpoint" else build_forward_artifact
    return build(files["port", container], max_batch, "cpu", devices)


@pytest.mark.parametrize("container", ["checkpoint", "artifact"])
@pytest.mark.parametrize("max_batch", [3, 6])
def test_forward_over_host_devices_matches_fenet(deploy_files, container, max_batch):
    """Over fenet's 8 host devices and the port's 8 replicas: the same
    rounded batch (3 -> 8, 6 -> 8), the same device count, fenet's clouds;
    and the one-device forward's rows."""
    want_fwd, want_meta = _fenet_forward(deploy_files, container, max_batch)
    fwd, meta = _port_forward(deploy_files, container, max_batch, ["cpu"] * HOST_DEVICES)
    assert meta["max_batch"] == want_meta["max_batch"] == 8
    assert meta["devices"] == want_meta["devices"] == HOST_DEVICES
    assert meta["num_points"] == 256 and meta["dtype"] == "float32"
    images = _images(max_batch, meta["max_batch"])
    out = fwd(images)
    assert isinstance(out, list) and len(out) == HOST_DEVICES
    got = fetch(out)
    assert got.shape == (8, 256, 3)
    np.testing.assert_allclose(got, np.asarray(want_fwd(images), np.float32), rtol=RTOL,
                               atol=ATOL)
    one, one_meta = _port_forward(deploy_files, container, max_batch, None)
    assert one_meta["devices"] == 1 and one_meta["max_batch"] == max_batch
    ref = fetch(one(images))
    assert np.abs(got - ref).max() <= SPLIT_REL * np.abs(ref).max()


def test_split_forward_rules():
    """round_batch is fenet's rounding; a batch that does not split over the
    devices raises; one device is the plain one-device forward."""
    assert [round_batch(b, 8) for b in (1, 3, 6, 8, 9, 33)] == [8, 8, 8, 8, 16, 40]
    assert round_batch(33, 2) == 34 and round_batch(5, 1) == 5
    fwd = device_forward([lambda x: x.float()] * 4, ["cpu"] * 4)
    with pytest.raises(ValueError, match="does not split over 4 devices"):
        fwd(_images(0, 6))
    shards = fwd(_images(0, 8))
    assert [tuple(s.shape) for s in shards] == [(2, 128, 128, 3)] * 4
    np.testing.assert_array_equal(fetch(shards), _images(0, 8).astype(np.float32))
    assert isinstance(device_forward([lambda x: x.float()], ["cpu"])(_images(0, 3)),
                      torch.Tensor)


def test_serving_devices(monkeypatch):
    """A bare 'cuda' is every visible card, an indexed one that card, an
    explicit list is kept (repeats too); without a card 'cuda' raises."""
    assert serving_devices("cpu") == [torch.device("cpu")]
    assert serving_devices("cuda", ["cpu", "cpu"]) == [torch.device("cpu")] * 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in ("cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="is_available"):
            serving_devices(spec)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert serving_devices("cuda") == [torch.device("cuda", i) for i in range(3)]
    assert serving_devices("cuda:1") == [torch.device("cuda", 1)]
    assert serving_devices("cuda", ["cuda:0", "cuda:0"]) == [torch.device("cuda", 0)] * 2


@pytest.fixture
def four_host_devices(monkeypatch):
    """Entry points that serve 'cpu' over four replicas on the host, as a
    host with four cards serves 'cuda' over all of them; yields the device
    lists the forwards were built over."""
    built = []

    def four(device="cuda", devices=None):
        built.append(serving_devices(device, devices or ["cpu"] * 4))
        return built[-1]

    monkeypatch.setattr(server, "serving_devices", four)
    monkeypatch.setattr(artifact, "serving_devices", four)
    yield built


@pytest.mark.parametrize("container", ["checkpoint", "artifact"])
def test_batcher_and_server_on_a_split_forward(deploy_files, four_host_devices, container):
    """The MicroBatcher on the split forward resolves each request to the
    one-device forward's row; make_server serves at the rounded batch."""
    path = deploy_files["port", container]
    fwd, meta = build_forward(path, 6, "cpu")
    assert meta["max_batch"] == 8 and meta["devices"] == 4
    one, _ = build_forward(path, 6, "cpu", ["cpu"])
    images = _images(11, 5)
    mb = MicroBatcher(fwd, max_batch=meta["max_batch"], window_ms=50.0)
    futures = [mb.submit(img) for img in images]
    got = np.stack([f.result(timeout=60) for f in futures])
    mb.close()
    padded = np.concatenate([images, images[-1:].repeat(3, 0)])
    ref = fetch(one(padded))[:5]
    assert np.abs(got - ref).max() <= SPLIT_REL * np.abs(ref).max()

    srv = make_server(path, port=0, max_batch=6, window_ms=1.0, device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{srv.server_address[1]}/healthz"
        health = json.load(urllib.request.urlopen(url, timeout=30))
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.close()
        thread.join(timeout=10)
    assert health["max_batch"] == 8 and health["devices"] == 4


def test_predict_on_a_split_forward(deploy_files, four_host_devices, tmp_path):
    """The predict CLI over four replicas writes the clouds the one-device
    forward computes, the last batch padded to the rounded batch."""
    import cv2

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(7):
        cv2.imwrite(str(imgs / f"view{i}.png"), _images(20 + i, 1)[0])
    path = deploy_files["port", "artifact"]
    written = predict.main(["--deploy_ckpt", path, "--images", str(imgs), "--out_dir",
                            str(tmp_path / "out"), "--batchSize", "3", "--device", "cpu"])
    assert len(written) == 7 and four_host_devices == [[torch.device("cpu")] * 4]
    one, _ = build_forward(path, 7, "cpu", ["cpu"])
    images = np.stack([predict._load_image(str(imgs / f"view{i}.png")) for i in range(7)])
    ref = fetch(one(images.astype(np.uint8)))
    for i in range(7):
        got = load_pointcloud(str(tmp_path / "out" / f"view{i}.ply"))
        assert np.abs(got - ref[i]).max() <= SPLIT_REL * np.abs(ref).max()


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_two_replicas_on_one_card_without_a_host_sync(cuda):
    """Two replicas on one card at max_batch 33 -> 34: the launches return
    with the work queued (a host sync raises under the sync debug mode),
    and the rows equal the one-device forward's to SPLIT_REL."""
    gen = to_deploy(init_random_(Generator(**SMALL), torch.Generator().manual_seed(0)).to(cuda))
    replica = lambda x: gen(x)[2]  # noqa: E731
    two = device_forward([replica, replica], [cuda, cuda])
    one = device_forward([replica], [cuda])
    batch = _images(30, round_batch(33, 2))
    two(batch)  # warm-up: cuDNN plans, the pinned block
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = two(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got, ref = fetch(out), fetch(one(batch))
    assert [s.device for s in out] == [cuda, cuda]
    assert np.abs(got - ref).max() <= SPLIT_REL * np.abs(ref).max()
