"""fenet_torch's native batch loader (fenet_torch/native) against the
per-item path, fenet's native loader and cv2, on synthetic trees.

Tolerance: exact. A native batch must equal the per-item path's and
fenet's load_batch byte for byte, dtypes included; a decoded PNG must equal
cv2.imread + BGR->RGB. Where the native path declines (a transform, a
render that is not 137 px, a missing file, a library that cannot be built)
load_batch returns None, DataLoader counts the batch as declined, and the
per-item path gives fenet's batch or raises fenet's error.
"""

import hashlib
import json
import logging
import os
import shutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from fenet import native as jax_native
from fenet.data.loader import DataLoader as JaxDataLoader
from fenet.data.shapenet import ShapeNetDataset as JaxShapeNetDataset
from fenet_torch import native
from fenet_torch.data import loader
from fenet_torch.data.loader import DataLoader, _collate
from fenet_torch.data.shapenet import ShapeNetDataset, load_split
from fenet_torch.data.synthetic import write_synthetic_shapenet
from fenet_torch.data.transforms import RandomFlip
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

REPO = Path(__file__).resolve().parent.parent
CAT = "02691156"
N = 256


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_tree")
    write_synthetic_shapenet(str(root), cats=(CAT,), models_per_cat=2, num_points=N)
    yield root
    shutil.rmtree(root, ignore_errors=True)


def _datasets(root, **kw):
    models = load_split(str(root / "splits"), "train_models.json")
    args = (str(root / "ShapeNetRendering") + "/", str(root / "ShapeNet_pointclouds") + "/",
            models, [CAT], N)
    return ShapeNetDataset(*args, **kw), JaxShapeNetDataset(*args, **kw)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_library_builds_into_build_dir_not_fenets(tmp_path, monkeypatch):
    """The default library lies under build/fenet_torch/ at the repo root;
    a fresh build goes where BUILD_DIR points, loads, and leaves fenet's
    tracked libfenet_loader.so as it was."""
    assert native.library_path().parent == REPO / "build" / "fenet_torch"
    assert native.get_lib() is not None and native.build_error() is None
    assert Path(native.get_lib()._name) == native.library_path()
    theirs = REPO / "fenet" / "native" / "libfenet_loader.so"
    before = hashlib.sha256(theirs.read_bytes()).hexdigest()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(native, "_lib", None)
    lib = native.get_lib()
    assert lib is not None and Path(lib._name).parent == tmp_path / "b"
    assert lib.fenet_torch_loader_version() == native.VERSION
    assert not hasattr(lib, "fenet_load_images")  # its own symbol names
    assert hashlib.sha256(theirs.read_bytes()).hexdigest() == before


def test_build_error_is_kept_logged_once_and_declined(tree, tmp_path, monkeypatch, caplog):
    """A compile that fails is not retried: its error, with g++'s output,
    is logged once and returned by build_error(); load_batch declines and
    the batch is counted as declined and served per item."""
    calls = []
    run = subprocess.run

    def counting_run(cmd, *a, **k):
        calls.append(cmd)
        return run(cmd, *a, **k)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-fno-such-flag"])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native.subprocess, "run", counting_run)
    with caplog.at_level(logging.ERROR, logger="fenet_torch.native"):
        assert native.get_lib() is None
        assert not native.native_available()
    assert len(calls) == 1 and "-fno-such-flag" in native.build_error()
    assert len(caplog.records) == 1 and "exited" in caplog.records[0].getMessage()
    with pytest.raises(RuntimeError, match="-fno-such-flag"):
        native.load_images([str(tree / "x.png")])
    ds, ref = _datasets(tree, image_dtype="uint8")
    monkeypatch.setattr(loader, "batch_counts", {"native": 0, "declined": 0})
    _assert_same(DataLoader(ds, 8)._make_batch(range(8)),
                 _collate([ref[i] for i in range(8)]))
    assert loader.batch_counts == {"native": 0, "declined": 1}


@pytest.mark.parametrize("image_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("kw", [{}, {"variety": True},
                                {"variety": True, "multi_resolution": True}],
                         ids=["plain", "variety", "variety_multi_resolution"])
def test_load_batch_matches_per_item_and_fenet(tree, image_dtype, kw):
    ds, ref = _datasets(tree, image_dtype=image_dtype, **kw)
    idx = [3, 30, 0, 47, 24, 11]
    got = ds.load_batch(idx)
    _assert_same(got, _collate([ds[i] for i in idx]))
    _assert_same(got, ref.load_batch(idx))


def test_load_batch_reads_float64_clouds(tree, tmp_path):
    root = tmp_path / "t"
    shutil.copytree(tree, root)
    for path in (root / "ShapeNet_pointclouds").glob("*/*/pointcloud_*.npy"):
        np.save(path, np.load(path).astype(np.float64) + 1e-9)
    ds, ref = _datasets(root, multi_resolution=True)
    idx = [1, 40, 7]
    got = ds.load_batch(idx)
    assert got["points"].dtype == np.float32
    _assert_same(got, _collate([ds[i] for i in idx]))
    _assert_same(got, ref.load_batch(idx))


def _adam7_png(path, rgb):
    """An interlaced (Adam7) 8-bit RGB PNG, every row unfiltered."""
    h, w, _ = rgb.shape
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = rgb[y0::dy, x0::dx]
        if sub.size:
            raw += b"".join(b"\0" + row.tobytes() for row in sub)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 1)
    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def _write_png(path, kind, rng):
    """A 137x137 PNG of the given kind."""
    rgb = rng.randint(0, 256, (137, 137, 3), np.uint8)
    if kind == "rgb8_max_compression":
        cv2.imwrite(path, rgb, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    elif kind == "rgba8":
        cv2.imwrite(path, rng.randint(0, 256, (137, 137, 4), np.uint8))
    elif kind == "gray8":
        cv2.imwrite(path, rgb[..., 0])
    elif kind == "rgb16":
        cv2.imwrite(path, rng.randint(0, 65536, (137, 137, 3)).astype(np.uint16))
    elif kind == "rgba16":
        cv2.imwrite(path, rng.randint(0, 65536, (137, 137, 4)).astype(np.uint16))
    elif kind == "gray16":
        cv2.imwrite(path, rng.randint(0, 65536, (137, 137)).astype(np.uint16))
    elif kind == "interlaced":
        _adam7_png(path, rgb)
    else:
        image = pytest.importorskip("PIL.Image")
        if kind == "palette8":
            image.fromarray(rgb).convert("P", palette=image.ADAPTIVE, colors=200).save(path)
        elif kind == "palette4":
            image.fromarray(rgb).convert("P", palette=image.ADAPTIVE, colors=16).save(
                path, bits=4)
        elif kind == "palette_trns":
            image.fromarray(rgb).convert("P", palette=image.ADAPTIVE, colors=50).save(
                path, transparency=3)
        elif kind == "gray1":
            image.fromarray(rgb[..., 0] > 127).save(path)
        elif kind == "gray_alpha8":
            image.fromarray(rgb[..., :2], mode="LA").save(path)


# fenet's libpng decode writes 4 bytes a pixel into 3-byte rows for a
# palette PNG with a tRNS chunk (it expands tRNS to alpha and strips alpha
# only for colour types that have it), corrupting the heap: that case is
# held against cv2 only.
FENET_SAFE = {"rgb8_max_compression", "rgba8", "gray8", "rgb16", "rgba16", "gray16",
              "interlaced", "palette8", "palette4", "gray1", "gray_alpha8"}


@pytest.mark.parametrize("kind", sorted(FENET_SAFE | {"palette_trns"}))
def test_decode_matches_cv2(kind, tmp_path):
    path = str(tmp_path / f"{kind}.png")
    _write_png(path, kind, np.random.RandomState(len(kind)))
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)[4:-5, 4:-5]
    got = native.load_images([path], dtype=np.uint8)[0]
    assert got.tobytes() == want.tobytes()
    assert native.load_images([path])[0].tobytes() == want.astype(np.float32).tobytes()
    if kind in FENET_SAFE:
        assert jax_native.load_images([path])[0].tobytes() == want.astype(
            np.float32).tobytes()


def test_load_clouds_rejects_another_shape_or_type(tmp_path):
    good = tmp_path / "good.npy"
    np.save(good, np.zeros((N, 3), np.float32))
    for name, arr in (("short", np.zeros((N - 1, 3), np.float32)),
                      ("wide", np.zeros((N, 4), np.float32)),
                      ("half", np.zeros((N, 3), np.float16)),
                      ("big_endian", np.zeros((N, 3), ">f4"))):
        np.save(tmp_path / f"{name}.npy", arr)
        with pytest.raises(IOError):
            native.load_clouds([str(good), str(tmp_path / f"{name}.npy")], N)
    assert native.load_clouds([str(good)], N).shape == (1, N, 3)


def test_declines_on_transform(tree, monkeypatch):
    ds, ref = _datasets(tree, transform=RandomFlip(rng=np.random.RandomState(0)))
    ref.transform = RandomFlip(rng=np.random.RandomState(0))
    monkeypatch.setattr(loader, "batch_counts", {"native": 0, "declined": 0})
    assert ds.load_batch([0, 1]) is None
    _assert_same(DataLoader(ds, 4)._make_batch([0, 1, 2, 3]),
                 JaxDataLoader(ref, 4)._make_batch([0, 1, 2, 3]))
    assert loader.batch_counts == {"native": 0, "declined": 1}


def test_declines_on_render_of_another_size(tree, tmp_path, monkeypatch):
    """A 150-px render: the native path declines, and the per-item path
    gives fenet's (141-px) crop."""
    root = tmp_path / "t"
    shutil.copytree(tree, root)
    models = load_split(str(root / "splits"), "train_models.json")[CAT]
    render = root / "ShapeNetRendering" / models[0] / "rendering" / "00.png"
    cv2.imwrite(str(render), np.random.RandomState(0).randint(0, 256, (150, 150, 3), np.uint8))
    ds, ref = _datasets(root, variety=True)
    monkeypatch.setattr(loader, "batch_counts", {"native": 0, "declined": 0})
    assert ds.load_batch([0]) is None
    _assert_same(DataLoader(ds, 1)._make_batch([0]), JaxDataLoader(ref, 1)._make_batch([0]))
    assert loader.batch_counts == {"native": 0, "declined": 1}


@pytest.mark.parametrize("missing", ["render", "cloud_128"])
def test_declines_on_missing_file(tree, tmp_path, monkeypatch, missing):
    """The native path declines; the per-item path raises the
    FileNotFoundError that fenet's per-item path raises."""
    root = tmp_path / "t"
    shutil.copytree(tree, root)
    model = load_split(str(root / "splits"), "train_models.json")[CAT][0]
    if missing == "render":
        (root / "ShapeNetRendering" / model / "rendering" / "02.png").unlink()
    else:
        (root / "ShapeNet_pointclouds" / model / "pointcloud_128.npy").unlink()
    ds, ref = _datasets(root, multi_resolution=True)
    monkeypatch.setattr(loader, "batch_counts", {"native": 0, "declined": 0})
    assert ds.load_batch([0, 2]) is None
    with pytest.raises(FileNotFoundError):
        _collate([ref[i] for i in range(4)])
    with pytest.raises(FileNotFoundError):
        next(iter(DataLoader(ds, 4)))
    assert loader.batch_counts == {"native": 0, "declined": 1}


@pytest.mark.parametrize("prefetch", [2, 0])
def test_shuffled_batches_match_fenet(tree, monkeypatch, prefetch):
    ds, ref = _datasets(tree, variety=True, image_dtype="uint8")
    kw = dict(shuffle=True, drop_last=False, prefetch=prefetch, seed=4)
    monkeypatch.setattr(loader, "batch_counts", {"native": 0, "declined": 0})
    ours, theirs = list(DataLoader(ds, 20, **kw)), list(JaxDataLoader(ref, 20, **kw))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        _assert_same(a, b)
    assert loader.batch_counts == {"native": 3, "declined": 0}


def test_train_net_takes_every_batch_natively(tree, tmp_path):
    """train_net on a written tree, on the CPU, in a process without JAX:
    every train and validation batch comes from load_batch."""
    code = f"""
import json, sys, torch
torch.set_num_threads(1)
from fenet_torch.data import loader
from fenet_torch.train.config import TrainConfig
from fenet_torch.train.driver import train_net
cfg = TrainConfig(batch_size=16, num_points={N}, nepoch=1, validate_epochs=(1,),
                  train_save_freq=0, emd_iters=50, manual_seed=0, backbone="RepVGG-TEST",
                  fine_width=32, mid_width=16, dir_path={str(tmp_path / "out")!r},
                  splits_path={str(tree / "splits")!r},
                  data_dir_imgs={str(tree / "ShapeNetRendering") + "/"!r},
                  data_dir_pcl={str(tree / "ShapeNet_pointclouds") + "/"!r})
out = train_net({CAT!r}, cfg, device="cpu")
print(json.dumps({{"counts": loader.batch_counts, "val": "val" in out["history"][0],
                  "jax": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "fenet"))}}))
"""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, timeout=600,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    # 48 samples: 3 train batches of 16, then 3 validation batches.
    assert result == {"counts": {"native": 6, "declined": 0}, "val": True, "jax": []}
