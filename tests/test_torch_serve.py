"""fenet_torch's serving path: the MicroBatcher (fenet's seven cases, on
numpy and on tensor results), export_deploy in both formats and both
dtypes, the torch.export artifact, the HTTP server, and the predict CLI
against fenet's on the same images and weights.

Tests marked ``gpu`` skip without a card. On the card, which has no JAX:
``python -m pytest --noconftest -m gpu tests/test_torch_serve.py``.
"""

import json
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

try:
    import jax

    from fenet.cli.export_deploy import main as jax_export_main
    from fenet.cli.predict import main as jax_predict_main
    from fenet.models.generator import Generator as JaxGenerator
    from fenet.models.generator import init_variables
    from fenet.train.checkpoint import export_torch_checkpoint, save_checkpoint
except ImportError:
    # The card machine has no JAX; there only the gpu tests run.
    pass
from fenet_torch.cli import export_deploy, predict
from fenet_torch.models.generator import Generator, init_random_, to_deploy
from fenet_torch.serve.artifact import load_artifact
from fenet_torch.serve.batcher import MicroBatcher
from fenet_torch.serve.server import build_forward, device_forward, make_server
from fenet_torch.utils.ply import load_pointcloud
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

SMALL = dict(num_points=256, backbone="RepVGG-TEST", fine_width=32, mid_width=16)
ARCH = ["--backbone", "RepVGG-TEST", "--num_points", "256", "--fine_width", "32",
        "--mid_width", "16"]
MAX_BATCH = 8
RTOL, ATOL = 1e-4, 1e-3  # port against fenet, float32 (tests/test_torch_models.py)
ARTIFACT_REL = 1e-6  # the artifact against the module it was exported from, of max|ref|


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- MicroBatcher: fenet's cases (tests/test_serve.py), each on numpy and on
# -- torch results ----------------------------------------------------------

def _result(kind, clouds):
    return clouds if kind == "numpy" else torch.from_numpy(clouds)


def _identityish_forward(calls, kind):
    """Records batch shapes; row i's cloud is filled with image i's mean, so
    fan-out can be checked row by row."""
    def forward(images):
        calls.append(images.shape)
        b = images.shape[0]
        means = images.reshape(b, -1).mean(axis=1).astype(np.float32)
        return _result(kind, np.tile(means[:, None, None], (1, 4, 3)))
    return forward


class _Lazy:
    """An in-flight result: materialising it sleeps, as a fetch waits for
    the device."""

    def __init__(self, val, fetch_ends=None, sleep=0.05):
        self.val, self.fetch_ends, self.sleep = val, fetch_ends, sleep

    def __array__(self, dtype=None, copy=None):
        time.sleep(self.sleep)
        if self.fetch_ends is not None:
            self.fetch_ends.append(time.time())
        return self.val.astype(dtype) if dtype is not None else self.val


def _case_batches_pads_and_fans_out(kind):
    calls = []
    mb = MicroBatcher(_identityish_forward(calls, kind), max_batch=4, window_ms=50.0)
    imgs = [np.full((2, 2, 3), v, np.uint8) for v in (10, 20, 30)]
    outs = [f.result(timeout=10) for f in [mb.submit(im) for im in imgs]]
    mb.close()
    for im, out in zip(imgs, outs):
        assert out.shape == (4, 3) and out.dtype == np.float32
        np.testing.assert_allclose(out, float(im.mean()))
    assert all(shape[0] == 4 for shape in calls)  # padded to max_batch
    assert len(calls) == 1  # the window gathered the burst


def _case_full_batch_dispatches_early_and_splits(kind):
    calls = []
    # A window long enough to hang the test if a full batch waited for it.
    mb = MicroBatcher(_identityish_forward(calls, kind), max_batch=2, window_ms=5000.0)
    futs = [mb.submit(np.full((2, 2, 3), v, np.uint8)) for v in (1, 2, 3, 4)]
    outs = [f.result(timeout=10) for f in futs]
    mb.close()
    assert [float(o[0, 0]) for o in outs] == [1.0, 2.0, 3.0, 4.0]
    assert len(calls) == 2


def _case_propagates_forward_errors_and_keeps_serving(kind):
    state = {"fail": True}

    def forward(images):
        if state["fail"]:
            raise RuntimeError("injected")
        return _result(kind, np.zeros((images.shape[0], 4, 3), np.float32))

    mb = MicroBatcher(forward, max_batch=2, window_ms=1.0)
    with pytest.raises(RuntimeError, match="injected"):
        mb.submit(np.zeros((2, 2, 3), np.uint8)).result(timeout=10)
    state["fail"] = False  # the dispatcher must have survived
    out = mb.submit(np.zeros((2, 2, 3), np.uint8)).result(timeout=10)
    mb.close()
    assert out.shape == (4, 3)


def _case_depth1_pipeline_overlaps_inflight_batches(kind):
    """Batch i+1 is dispatched before batch i's fetch completes."""
    dispatches, fetch_ends = [], []

    def forward(images):
        dispatches.append(time.time())
        b = images.shape[0]
        means = images.reshape(b, -1).mean(axis=1).astype(np.float32)
        return _Lazy(np.tile(means[:, None, None], (1, 4, 3)), fetch_ends)

    mb = MicroBatcher(forward, max_batch=1, window_ms=1.0)
    futs = [mb.submit(np.full((2, 2, 3), v, np.uint8)) for v in (5, 6, 7, 8)]
    outs = [f.result(timeout=30) for f in futs]
    mb.close()
    for v, out in zip((5, 6, 7, 8), outs):
        np.testing.assert_allclose(out, float(v))
    assert len(dispatches) == 4 and len(fetch_ends) == 4
    assert dispatches[1] < fetch_ends[0]


def _case_shape_mismatch_fails_batch_not_dispatcher(kind):
    calls = []
    mb = MicroBatcher(_identityish_forward(calls, kind), max_batch=2, window_ms=50.0)
    f1 = mb.submit(np.zeros((2, 2, 3), np.uint8))
    f2 = mb.submit(np.zeros((4, 4, 3), np.uint8))  # np.stack must raise
    with pytest.raises(ValueError):
        f1.result(timeout=10)
    with pytest.raises(ValueError):
        f2.result(timeout=10)
    out = mb.predict(np.full((2, 2, 3), 9, np.uint8))  # still serving
    mb.close()
    np.testing.assert_allclose(out, 9.0)


def _case_forward_error_still_resolves_pending(kind):
    """A failing dispatch does not strand the batch in flight before it."""
    def forward(images):
        if images.shape[1] == 4:  # the poisoned request
            raise RuntimeError("boom")
        b = images.shape[0]
        means = images.reshape(b, -1).mean(axis=1).astype(np.float32)
        return _Lazy(np.tile(means[:, None, None], (1, 4, 3)), sleep=0.02)

    mb = MicroBatcher(forward, max_batch=1, window_ms=1.0)
    good = mb.submit(np.full((2, 2, 3), 7, np.uint8))
    bad = mb.submit(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(RuntimeError, match="boom"):
        bad.result(timeout=10)
    np.testing.assert_allclose(good.result(timeout=10), 7.0)
    mb.close()


def _case_concurrent_submitters(kind):
    calls = []
    mb = MicroBatcher(_identityish_forward(calls, kind), max_batch=8, window_ms=20.0)
    results = {}

    def worker(v):
        results[v] = mb.predict(np.full((2, 2, 3), v, np.uint8))

    threads = [threading.Thread(target=worker, args=(v,)) for v in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    mb.close()
    assert not any(t.is_alive() for t in threads)
    assert len(results) == 16
    for v, out in results.items():
        np.testing.assert_allclose(out, float(v))


BATCHER_CASES = [
    _case_batches_pads_and_fans_out,
    _case_full_batch_dispatches_early_and_splits,
    _case_propagates_forward_errors_and_keeps_serving,
    _case_depth1_pipeline_overlaps_inflight_batches,
    _case_shape_mismatch_fails_batch_not_dispatcher,
    _case_forward_error_still_resolves_pending,
    _case_concurrent_submitters,
]


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("case", BATCHER_CASES, ids=lambda c: c.__name__[len("_case_"):])
def test_microbatcher(case, kind):
    case(kind)


class _FaultyTensor(torch.Tensor):
    """A result whose copy to the host fails, as a device fault surfaces at
    the fetch of an asynchronous launch."""

    def cpu(self, *args, **kwargs):
        raise RuntimeError("injected device fault")


def _device_fault_at_fetch(device):
    state = {"fault": True}

    def forward(images):
        out = torch.zeros(images.shape[0], 4, 3, device=device)
        return out.as_subclass(_FaultyTensor) if state["fault"] else out

    mb = MicroBatcher(forward, max_batch=2, window_ms=1.0)
    futs = [mb.submit(np.zeros((2, 2, 3), np.uint8)) for _ in range(2)]
    for fut in futs:
        with pytest.raises(RuntimeError, match="injected device fault"):
            fut.result(timeout=10)
    state["fault"] = False  # the dispatcher survived the fetch
    out = mb.predict(np.zeros((2, 2, 3), np.uint8))
    mb.close()
    assert out.shape == (4, 3)


def test_device_fault_at_fetch_fails_its_batch_only():
    _device_fault_at_fetch("cpu")


# -- export_deploy, the artifact, build_forward ------------------------------

def _randomize_bn_(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.3, 0.3, generator=g)
                m.running_mean.normal_(0.0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """A branched port model with random BN statistics, saved as the
    reference's model_best.pth.tar; (path, model). The directory, with the
    deploy files ``exports`` writes beside the checkpoint, is deleted after
    the module's tests."""
    gen = _randomize_bn_(init_random_(Generator(**SMALL), torch.Generator().manual_seed(0)), 1)
    path = tmp_path_factory.mktemp("port") / "model_best.pth.tar"
    torch.save({"state_dict": gen.state_dict()}, path)
    yield path, gen.eval()
    shutil.rmtree(path.parent, ignore_errors=True)


def _images(seed, b):
    return np.random.RandomState(seed).randint(0, 256, (b, 128, 128, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def exports(port_ckpt):
    """export_deploy's four outputs, by (format, dtype)."""
    path, _ = port_ckpt
    out = {}
    for fmt in ("torch", "export"):
        for dtype in ("float32", "bfloat16"):
            out[fmt, dtype] = export_deploy.main([
                "--model", str(path), *ARCH, "--device", "cpu", "--dtype", dtype,
                "--format", fmt, "--out", str(path.parent / f"deploy_{dtype}.{fmt}")
                + (".pt2" if fmt == "export" else "")])
    return out


@pytest.mark.parametrize("fmt", ["torch", "export"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_deploy_round_trip(port_ckpt, exports, fmt, dtype):
    """Each export serves what ``to_deploy`` of the same weights computes:
    the folded checkpoint bit for bit, the artifact to 1e-6 of max|ref|."""
    _, gen = port_ckpt
    path = exports[fmt, dtype]
    ref_model = to_deploy(gen, export_deploy.DTYPES[dtype])
    images = _images(4, 3)
    with torch.inference_mode():
        ref = ref_model(torch.tensor(images))[2].float()
    sidecar = json.load(open(path + ".json"))
    assert sidecar["dtype"] == dtype and sidecar["num_points"] == 256
    assert sidecar["backbone"] == "RepVGG-TEST" and sidecar["fine_width"] == 32
    if fmt == "torch":
        model, got_dtype = export_deploy.load_deploy_checkpoint(path, "cpu")
        assert got_dtype == export_deploy.DTYPES[dtype] and model.deploy
        assert all(p.dtype == got_dtype for p in model.parameters())
        with torch.inference_mode():
            got = model(torch.tensor(images))[2].float()
        assert torch.equal(got, ref)
    else:
        assert sidecar["format"] == "torch.export" and path.endswith(".pt2")
        assert sidecar["n_params"] == sum(p.numel() for p in ref_model.parameters())
        assert 0 < sidecar["program_bytes"] < sidecar["bytes"]
        assert sidecar["weight_bytes"] <= sidecar["bytes"]
        call, meta = load_artifact(path, "cpu")
        assert meta == sidecar
        got = call(images).float()  # numpy in, as fenet's loader takes
        assert float((got - ref).abs().max()) <= ARTIFACT_REL * float(ref.abs().max())


def test_load_deploy_checkpoint_enforces_the_sidecar_dtype(exports, tmp_path):
    """A float32 state_dict under a bfloat16 sidecar serves in bfloat16."""
    import shutil

    path = str(tmp_path / "deploy.pth")
    shutil.copyfile(exports["torch", "float32"], path)
    meta = json.load(open(exports["torch", "float32"] + ".json"))
    json.dump(dict(meta, dtype="bfloat16"), open(path + ".json", "w"))
    model, dtype = export_deploy.load_deploy_checkpoint(path, "cpu")
    assert dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())


@pytest.mark.parametrize("batch", [1, 3, MAX_BATCH])
def test_artifact_batches(port_ckpt, exports, batch):
    """One exported program at any batch: its rows equal the module's."""
    _, gen = port_ckpt
    forward, meta = build_forward(exports["export", "float32"], MAX_BATCH, "cpu")
    assert meta["max_batch"] == MAX_BATCH and meta["devices"] == 1
    images = _images(batch, batch)
    got = forward(images)
    with torch.inference_mode():
        ref = to_deploy(gen)(torch.tensor(images))[2]
    assert tuple(got.shape) == (batch, 256, 3)
    assert float((got - ref).abs().max()) <= ARTIFACT_REL * float(ref.abs().max())


@pytest.mark.parametrize("fmt", ["torch", "export"])
def test_build_forward_serves_an_odd_batch(exports, fmt):
    """Both containers through build_forward, at a max_batch that no device
    count divides: one device, no rounding."""
    forward, meta = build_forward(exports[fmt, "bfloat16"], 3, "cpu")
    assert meta["max_batch"] == 3 and meta["dtype"] == "bfloat16" and meta["num_points"] == 256
    mb = MicroBatcher(forward, max_batch=meta["max_batch"], window_ms=1.0)
    out = mb.predict(np.zeros((128, 128, 3), np.uint8))
    mb.close()
    assert out.shape == (256, 3) and out.dtype == np.float32 and np.all(np.isfinite(out))


def test_default_device_raises_without_a_card(exports, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for path in (exports["torch", "float32"], exports["export", "float32"]):
        with pytest.raises(RuntimeError, match="cuda"):
            build_forward(path, 2)


# -- the HTTP server ---------------------------------------------------------

@pytest.fixture(scope="module")
def http_server(exports):
    """make_server on the bf16 artifact, as the serving quick start runs it."""
    server = make_server(exports["export", "bfloat16"], port=0, max_batch=MAX_BATCH,
                         window_ms=5.0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    server.batcher.close()
    thread.join(timeout=10)


def _png_bytes(side=137, seed=0):
    import cv2

    rng = np.random.RandomState(seed)
    ok, buf = cv2.imencode(".png", rng.randint(0, 256, (side, side, 3), np.uint8))
    assert ok
    return buf.tobytes()


def _post(base, path, body):
    return urllib.request.urlopen(urllib.request.Request(base + path, data=body), timeout=120)


def _stats(base):
    return json.load(urllib.request.urlopen(base + "/stats", timeout=30))


def test_http_healthz_and_stats(http_server):
    _, base = http_server
    health = json.load(urllib.request.urlopen(base + "/healthz", timeout=30))
    assert health["status"] == "ok" and health["num_points"] == 256
    assert health["dtype"] == "bfloat16" and health["max_batch"] == MAX_BATCH
    assert set(_stats(base)) == {"served", "errors"}


def test_http_predict_json_and_ply(http_server):
    _, base = http_server
    body = _png_bytes(seed=1)
    pts = np.asarray(json.load(_post(base, "/predict", body))["points"], np.float32)
    assert pts.shape == (256, 3) and np.all(np.isfinite(pts))
    resp = _post(base, "/predict?format=ply", body)
    assert resp.headers["Content-Type"] == "application/octet-stream"
    import tempfile

    with tempfile.NamedTemporaryFile(suffix=".ply") as f:
        f.write(resp.read())
        f.flush()
        cloud = load_pointcloud(f.name)
    np.testing.assert_array_equal(cloud, pts)  # the same image on both formats


def test_http_routes_are_exact(http_server):
    """Lookalike paths 404; ``format=ply`` inside another parameter does
    not select PLY."""
    _, base = http_server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, "/predictfoo", _png_bytes(seed=9))
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + "/stats/", timeout=30)
    assert err.value.code == 404
    resp = _post(base, "/predict?note=format%3Dply", _png_bytes(seed=9))
    assert resp.headers["Content-Type"] == "application/json"


def test_http_predict_rejects_garbage(http_server):
    server, base = http_server
    before = server.stats.snapshot()
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, "/predict", b"not an image")
    assert err.value.code == 400
    # Counted before the reply: no wait is needed to see it.
    assert _stats(base) == {"served": before["served"], "errors": before["errors"] + 1}


def test_http_concurrent_clients_are_counted_before_their_replies(http_server):
    """Concurrent clients share padded batches; distinct images give
    distinct clouds; ``served`` includes every request the moment the last
    reply is in, with no sleep or retry (fenet counts after replying)."""
    server, base = http_server
    before = server.stats.snapshot()["served"]
    results = {}

    def worker(seed):
        resp = json.load(_post(base, "/predict", _png_bytes(seed=seed)))
        results[seed] = np.asarray(resp["points"], np.float32)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(2, 14)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert _stats(base)["served"] == before + 12
    assert len(results) == 12
    for out in results.values():
        assert out.shape == (256, 3) and np.all(np.isfinite(out))
    flat = [tuple(np.round(v[:2].ravel(), 4)) for v in results.values()]
    assert len(set(flat)) == len(flat)


# -- predict against fenet's -------------------------------------------------

def test_predict_matches_fenet(tmp_path):
    """Both predict CLIs on the same PNGs from the same weights: fenet's
    deploy checkpoint from its export_deploy, the port's from the converted
    .pth.tar through its own export_deploy; float32, padded last batch,
    colliding names."""
    import cv2

    model = JaxGenerator(**SMALL)
    v = jax.tree_util.tree_map(np.asarray, init_variables(
        model, np.zeros((1, 128, 128, 3), np.float32), rng=jax.random.PRNGKey(2)))
    rng = np.random.RandomState(6)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 2.0, x.shape) if p[-1].key == "var"
                      else rng.normal(0.0, 0.3, x.shape)).astype(np.float32),
        v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    ckpt = tmp_path / "ckpt"
    save_checkpoint({**v, "epoch": 1}, True, "t", str(ckpt), 1)
    export_torch_checkpoint(v, str(ckpt / "model_best.pth.tar"))
    jax_deploy = jax_export_main(["--model", str(ckpt), *ARCH,
                                  "--out", str(tmp_path / "fenet_deploy.ckpt")])
    port_deploy = export_deploy.main(["--model", str(ckpt), *ARCH, "--device", "cpu",
                                      "--out", str(tmp_path / "port_deploy.pth")])

    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i, side in enumerate((137, 128, 150, 137, 96)):
        img = np.random.RandomState(10 + i).randint(0, 256, (side, side, 3), np.uint8)
        cv2.imwrite(str(imgs / f"view{i}.png"), img)
    cv2.imwrite(str(imgs / "view0.jpg"), np.full((137, 137, 3), 90, np.uint8))
    common = ["--images", str(imgs), "--batchSize", "4", "--ply_binary"]
    want = jax_predict_main(["--deploy_ckpt", jax_deploy, "--out_dir",
                             str(tmp_path / "fenet_out"), *common])
    got = predict.main(["--deploy_ckpt", port_deploy, "--out_dir",
                        str(tmp_path / "port_out"), "--device", "cpu", *common])
    names = sorted(p.rsplit("/", 1)[-1] for p in got)
    assert names == sorted(p.rsplit("/", 1)[-1] for p in want)
    assert len(names) == 6 and "view0_1.ply" in names
    for name in names:
        a = load_pointcloud(str(tmp_path / "port_out" / name))
        b = load_pointcloud(str(tmp_path / "fenet_out" / name))
        assert a.shape == (256, 3)
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=name)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_device_forward_dispatches_without_a_host_sync_on_card(cuda):
    """The pinned, non-blocking upload and the forward return with the work
    still queued (a host sync raises under the sync debug mode), and the
    rows equal the module's on the same images."""
    gen = to_deploy(_randomize_bn_(
        init_random_(Generator(**SMALL), torch.Generator().manual_seed(0)), 1).to(cuda))
    forward = device_forward([lambda x: gen(x)[2]], [cuda])
    batches = [_images(s, MAX_BATCH) for s in range(3)]
    forward(batches[0])  # warm-up: cuDNN plans, the pinned block
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [forward(b) for b in batches]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for images, out in zip(batches, outs):
        assert out.device.type == "cuda"
        with torch.inference_mode():
            ref = gen(torch.tensor(images, device=cuda))[2]
        assert torch.equal(out, ref)


@pytest.mark.gpu
def test_device_fault_at_fetch_fails_its_batch_only_on_card(cuda):
    _device_fault_at_fetch(cuda)
