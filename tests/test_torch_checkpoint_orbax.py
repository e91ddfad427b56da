"""fenet's orbax checkpoint container in fenet_torch, against fenet, orbax,
tensorstore and libzstd: the OCDBT reader against tensorstore's
``ocdbt`` kvstore (inline and indirect values, b-trees of several levels,
more versions than one version-tree leaf holds, uncompressed nodes, an
emptied store, corruption), zstd frames against numpy, zarr v2 arrays
written by tensorstore's ``zarr`` driver, a fenet-written training state
against the same state's ``.ckpt``, a port-written directory restored by
fenet, the train CLI resuming the newest of three containers, the CLIs'
lookup order, eval and ``export_deploy`` from a ``.orbax``, the error
without libzstd, and the committed fixture (``tests/fixtures/fenet_orbax``,
written by ``tests/make_orbax_fixture.py``) against its seeded arrays.

The train CLI runs a torch backward, so it runs in a subprocess (torch
autograd and XLA:CPU corrupt the heap in one process).

Tolerances: none. Every container, array, byte, metric and deploy file is
compared bit for bit: the loads under test return the same numbers, not
nearby ones.
"""

import argparse
import ctypes
import json
import logging
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard

from fenet.models.convert import merge_variables, torch_state_dict_to_variables
from fenet.models.generator import Generator as JaxGenerator
from fenet.models.generator import init_variables
from fenet.train.checkpoint import fetch_arrays
from fenet.train.checkpoint import load_checkpoint as jax_load_checkpoint
from fenet.train.checkpoint import save_checkpoint as jax_save_checkpoint
from fenet.train.config import TrainConfig as JaxTrainConfig
from fenet.train.trainer import Trainer as JaxTrainer
from fenet_torch.cli import common, eval_shapenet, export_deploy, record_goldens
from fenet_torch.data.synthetic import write_synthetic_shapenet
from fenet_torch.models.convert import param_names, state_dict_from_jax
from fenet_torch.models.generator import Generator, init_random_
from fenet_torch.native import zstd
from fenet_torch.train import checkpoint, flax_msgpack, ocdbt, orbax, zarr2
from fenet_torch.train.driver import _newest_checkpoint
from torch_tmp import remove_tmp_path  # noqa: F401  (deletes each test's tmp_path)

sys.path.insert(0, str(Path(__file__).resolve().parent))
import make_orbax_fixture  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(backbone="RepVGG-TEST", fine_width=32, mid_width=16)
N_POINTS = 256
CAT = "02691156"
ARCH = ["--num_points", str(N_POINTS), "--backbone", SMALL["backbone"],
        "--fine_width", "32", "--mid_width", "16"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_trees_equal(got, want, path=""):
    """Same keys in the same order, leaves of the same type, dtype, shape
    and bytes (a torch bfloat16 leaf against uint16 bits or a torch
    bfloat16 leaf)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, list(got), list(want))
        for key in want:
            _assert_trees_equal(got[key], want[key], f"{path}/{key}")
        return
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16, path
        want = want.view(torch.int16).numpy() if isinstance(want, torch.Tensor) else want
        assert np.array_equal(got.view(torch.int16).numpy().view(np.uint16),
                              np.asarray(want).view(np.uint16)), path
        return
    assert type(got) is type(want), (path, type(got), type(want))
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert got.tobytes() == want.tobytes(), path


def _assert_blobs_equal(a, b):
    """Two port blobs: state_dict, Adam's state and the scalars, bit for
    bit (NaN scalars equal)."""
    assert list(a["state_dict"]) == list(b["state_dict"])
    for key, value in a["state_dict"].items():
        assert value.dtype == b["state_dict"][key].dtype, key
        assert torch.equal(value, b["state_dict"][key]), key
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    assert a["optimizer"]["state"].keys() == b["optimizer"]["state"].keys()
    for i, entry in a["optimizer"]["state"].items():
        for key, value in entry.items():
            other = b["optimizer"]["state"][i][key]
            assert value.dtype == other.dtype and torch.equal(value, other), (i, key)
    scalars = [k for k in a if k not in ("state_dict", "optimizer")]
    assert scalars == [k for k in b if k not in ("state_dict", "optimizer")]
    assert json.dumps({k: a[k] for k in scalars}) == json.dumps({k: b[k] for k in scalars})


def _ts_store(root, **config):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                            **({"config": config} if config else {})}).result()


def _assert_store_matches_tensorstore(root):
    """The port's list and read against tensorstore's; returns the store."""
    store = ocdbt.Store(str(root))
    kv = _ts_store(root)
    want = sorted(k.decode() for k in kv.list().result())
    assert [k for k, _ in store.list()] == want
    for key, length in store.list():
        value = kv.read(key).result().value
        assert length == len(value) and bytes(store.read(key)) == value, key
    return store


def _kinds(store):
    """{key: "inline" or "indirect"} of every entry."""
    return {e.key.decode(): "inline" if e.ref is None else "indirect"
            for e in store._entries.values()}


# -- the OCDBT reader -----------------------------------------------------------

@pytest.fixture(scope="module")
def fenet_orbax(tmp_path_factory):
    """A tree fenet writes with save_checkpoint(fmt="orbax"), both as
    orbax writes it and with orbax's node size cut to 400 bytes, so that
    its merged b-tree has several levels."""
    from orbax.checkpoint._src.serialization import tensorstore_utils

    root = tmp_path_factory.mktemp("fenet_orbax")
    rng = np.random.RandomState(0)
    tree = {"params": {f"layer{i}": {"kernel": rng.randn(40, 40 * (i + 1)).astype(np.float32),
                                     "bias": rng.randn(40).astype(np.float32)}
                       for i in range(8)}, "batch_stats": {}}
    paths = {"default": jax_save_checkpoint(tree, False, "c", str(root / "default"), 1,
                                            fmt="orbax")}
    original = tensorstore_utils.add_ocdbt_write_options

    def small_nodes(spec, target_data_file_size=None):
        original(spec, target_data_file_size)
        spec["config"]["max_decoded_node_bytes"] = 400

    tensorstore_utils.add_ocdbt_write_options = small_nodes
    try:
        paths["small_nodes"] = jax_save_checkpoint(tree, False, "c", str(root / "small"), 1,
                                                   fmt="orbax")
    finally:
        tensorstore_utils.add_ocdbt_write_options = original
    yield dict(tree=tree, **paths)
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("layout", ["default", "small_nodes"])
def test_ocdbt_reads_fenets_store_as_tensorstore_does(fenet_orbax, layout):
    """Every key and value of a fenet-written store, the root's merged tree
    and the per-process store it names; inline and indirect values; an
    indirect value is a view of its data file's mapping."""
    path = Path(fenet_orbax[layout])
    store = _assert_store_matches_tensorstore(path)
    _assert_store_matches_tensorstore(path / "ocdbt.process_0")
    kinds = _kinds(store)
    assert {"inline", "indirect"} <= set(kinds.values())
    assert kinds["params.layer7.kernel/.zarray"] == "inline"
    assert kinds["params.layer7.kernel/0.0"] == "indirect"
    value = store.read("params.layer7.kernel/0.0")
    assert isinstance(value, memoryview) and value.readonly
    assert type(value.obj).__name__ == "mmap"
    _, versions = ocdbt.parse_manifest((path / ocdbt.MANIFEST).read_bytes())
    height = max(versions, key=lambda v: v.generation).height
    assert (height > 1) == (layout == "small_nodes")


@pytest.mark.parametrize("compression", ["zstd", "none"])
def test_ocdbt_deep_trees_and_many_versions(tmp_path, compression):
    """40 commits (a version tree of more than one leaf: 16 versions a
    node) with 300-byte nodes and 16-byte inline values, keys sharing long
    prefixes; nodes zstd-compressed or not; then every key deleted."""
    config = {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16,
              "compression": {"id": "zstd", "level": 7} if compression == "zstd"
              else None}
    kv = _ts_store(tmp_path, **config)
    for i in range(40):
        kv.write(f"group/{i % 3}/key{i:03d}", bytes(range(i % 7)) * (i % 9 + 1)).result()
    store = _assert_store_matches_tensorstore(tmp_path)
    assert set(_kinds(store).values()) == {"inline", "indirect"}
    config, versions = ocdbt.parse_manifest((tmp_path / ocdbt.MANIFEST).read_bytes())
    assert config.compression == (1 if compression == "zstd" else 0)
    assert config.max_inline_value_bytes == 16 and config.max_decoded_node_bytes == 300
    newest = max(versions, key=lambda v: v.generation)
    assert newest.generation > 16 and newest.height >= 2 and newest.num_keys == 40
    assert len(store.read("group/1/key001")) == 2
    with pytest.raises(KeyError):
        store.read("group/0/key001")
    kv.delete_range(ts.KvStore.KeyRange()).result()
    assert list(ocdbt.Store(str(tmp_path)).list()) == []


def test_ocdbt_rejects_corruption(tmp_path):
    """A flipped byte fails the node's CRC-32C; a wrong length, magic or
    numbered manifest raises; CRC-32C against its check value."""
    assert ocdbt.crc32c(b"123456789") == 0xE3069283
    kv = _ts_store(tmp_path / "s")
    kv.write("k", b"v" * 2000).result()
    manifest = (tmp_path / "s" / ocdbt.MANIFEST).read_bytes()
    bad = bytearray(manifest)
    bad[20] ^= 1
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.parse_manifest(bytes(bad))
    with pytest.raises(ValueError, match="header says"):
        ocdbt.parse_manifest(manifest[:-1])
    with pytest.raises(ValueError, match="magic"):
        ocdbt.decode_object(manifest, ocdbt.NODE_MAGIC, "node")
    numbered = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path / 'n'}/",
                                "config": {"manifest_kind": "numbered"}}).result()
    numbered.write("k", b"v").result()
    with pytest.raises((ValueError, FileNotFoundError), match="manifest"):
        ocdbt.Store(str(tmp_path / "n"))
    root = max(ocdbt.parse_manifest(manifest)[1], key=lambda v: v.generation).root
    node = tmp_path / "s" / root.file.path
    data = bytearray(node.read_bytes())
    data[root.offset + root.length // 2] ^= 0x40
    node.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC-32C"):
        ocdbt.Store(str(tmp_path / "s"))


# -- zstd -------------------------------------------------------------------------

def _zstd_blocks(frame: bytes):
    """(block type, literals type) of each block of one zstd frame: types
    raw 0, RLE 1, compressed 2; literals raw 0, RLE 1, Huffman 2,
    treeless 3 (None outside a compressed block)."""
    fhd = frame[4]
    pos = 5 + (0 if fhd & 0x20 else 1)  # window descriptor unless single segment
    pos += (0, 1, 2, 4)[fhd & 3]  # dictionary id
    pos += (1 if fhd & 0x20 else 0, 2, 4, 8)[fhd >> 6]  # content size
    blocks = []
    while True:
        header = int.from_bytes(frame[pos:pos + 3], "little")
        kind, size = (header >> 1) & 3, header >> 3
        blocks.append((kind, frame[pos + 3] & 3 if kind == 2 else None))
        pos += 3 + (1 if kind == 1 else size)
        if header & 1:
            return blocks


@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_frames_against_numpy(level):
    """Frames of several blocks, with and without a content size (fenet's
    have none), decoded into a buffer of the known size and into a growing
    one; a size mismatch and a truncated frame raise."""
    rng = np.random.RandomState(level)
    x = np.concatenate([rng.randn(1 << 16).astype(np.float32),
                        np.repeat(rng.randn(1 << 10).astype(np.float32), 64)])
    frames = [zstandard.ZstdCompressor(level=level, write_content_size=False).compress(x),
              zstd.compress(x, level)]
    for frame in frames:
        blocks = _zstd_blocks(frame)
        assert len(blocks) >= 2 and (2, 2) in blocks, blocks
        out = np.empty_like(x)
        zstd.decompress_into(frame, out)
        assert out.tobytes() == x.tobytes()
        out = torch.empty(x.shape, dtype=torch.float32)
        zstd.decompress_into(memoryview(frame), out)
        assert out.numpy().tobytes() == x.tobytes()
        assert bytes(zstd.decompress(frame)) == x.tobytes()
        with pytest.raises(ValueError, match="more than"):
            zstd.decompress_into(frame, np.empty(x.size - 1, np.float32))
        with pytest.raises(ValueError, match="not the"):
            zstd.decompress_into(frame, np.empty(x.size + 1, np.float32))
        with pytest.raises(ValueError, match="truncated"):
            zstd.decompress_into(frame[:-9], np.empty_like(x))
        with pytest.raises(ValueError, match="truncated"):
            zstd.decompress(frame[:-9])


# -- zarr v2 ---------------------------------------------------------------------

def _ts_zarr(kvstore, name, data, chunks, dtype, compressor, fill=None, sep=".", region=None):
    meta = {"shape": list(np.shape(data)), "chunks": list(chunks), "dtype": dtype,
            "compressor": compressor, "fill_value": fill, "dimension_separator": sep}
    array = ts.open({"driver": "zarr", "kvstore": kvstore, "path": name, "metadata": meta,
                     "create": True}).result()
    value = np.asarray(data).astype(array.dtype.numpy_dtype)
    if region is None:
        array.write(value).result()
    else:
        array[region].write(value[region]).result()
    return array


@pytest.mark.parametrize("kvstore", ["file", "ocdbt"])
def test_zarr_arrays_written_by_tensorstore(tmp_path, kvstore):
    """Several chunks with edge chunks, every dtype fenet's trees hold,
    0-d, bfloat16, both separators, zstd and no compressor, and chunks
    never written read as fill_value."""
    spec = ({"driver": "file", "path": str(tmp_path)} if kvstore == "file"
            else {"driver": "ocdbt", "base": f"file://{tmp_path}/"})
    rng = np.random.RandomState(1)
    zst = {"id": "zstd", "level": 3}
    cases = {
        "f4": (rng.randn(37, 21).astype(np.float32), (8, 5), "<f4", zst, None, "."),
        "f8": (rng.randn(11, 3, 4), (4, 3, 3), "<f8", None, None, "/"),
        "i4": (rng.randint(-9, 9, 40).astype(np.int32), (16,), "<i4", zst, None, "."),
        "i8": (rng.randint(-9, 9, (6, 6)), (6, 6), "<i8", None, None, "."),
        "u1": (rng.randint(0, 255, (5, 9)).astype(np.uint8), (2, 4), "|u1", zst, None, "/"),
        "b1": (rng.rand(13) > 0.5, (5,), "|b1", zst, None, "."),
        "scalar": (np.asarray(7, np.int32), (), "<i4", zst, None, "."),
    }
    for name, (data, chunks, dtype, comp, fill, sep) in cases.items():
        _ts_zarr(spec, name, data, chunks, dtype, comp, fill, sep)
    bf16 = _ts_zarr(spec, "bf16", rng.randn(5, 3), (2, 2), "bfloat16", zst)
    x = rng.randn(10, 7).astype(np.float32)
    _ts_zarr(spec, "partial", x, (4, 4), "<f4", zst, fill=7.5, region=np.s_[0:4, 0:4])
    _ts_zarr(spec, "nan_fill", x, (4, 4), "<f4", None, fill="NaN", region=np.s_[4:8, 4:7])
    source = zarr2.Directory(str(tmp_path)) if kvstore == "file" else ocdbt.Store(str(tmp_path))
    for name, (data, *_rest) in cases.items():
        got = zarr2.read_array(source, name)
        assert type(got) is np.ndarray and got.dtype == data.dtype and got.shape == data.shape
        assert got.tobytes() == data.tobytes(), name
    got = zarr2.read_array(source, "bf16")
    want = np.asarray(bf16.read().result())
    assert got.dtype == torch.bfloat16 and np.array_equal(
        got.view(torch.int16).numpy(), want.view(np.int16))
    want = np.full_like(x, 7.5)
    want[0:4, 0:4] = x[0:4, 0:4]
    assert zarr2.read_array(source, "partial").tobytes() == want.tobytes()
    want = np.full_like(x, np.nan)
    want[4:8, 4:7] = x[4:8, 4:7]
    np.testing.assert_array_equal(zarr2.read_array(source, "nan_fill"), want)


def test_zarr_refuses_what_it_cannot_read(tmp_path):
    """Order F, another compressor, filters and a big-endian dtype raise and
    name themselves; the port's writer's arrays read back as views."""
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    zarr2.write_array(str(tmp_path), "w", x)
    meta = json.loads((tmp_path / "w" / ".zarray").read_text())
    assert meta["compressor"] is None and meta["chunks"] == [3, 4]
    got = zarr2.read_array(zarr2.Directory(str(tmp_path)), "w")
    assert got.tobytes() == x.tobytes() and got.flags.writeable and not got.flags.owndata
    for change, match in (({"order": "F"}, "order 'F'"),
                          ({"compressor": {"id": "blosc"}}, "compressor 'blosc'"),
                          ({"filters": [{"id": "delta"}]}, "filters"),
                          ({"dtype": ">f4"}, "'>f4'"),
                          ({"zarr_format": 3}, "zarr_format")):
        (tmp_path / "w" / ".zarray").write_text(json.dumps({**meta, **change}))
        with pytest.raises(ValueError, match=match):
            zarr2.read_array(zarr2.Directory(str(tmp_path)), "w")


# -- training checkpoints ----------------------------------------------------------

def _port_init_variables(model, seed=0):
    gen = init_random_(Generator(num_points=N_POINTS, **SMALL),
                       torch.Generator().manual_seed(seed))
    init = jax.tree_util.tree_map(np.asarray, init_variables(
        model, np.zeros((1, 128, 128, 3), np.float32), rng=jax.random.PRNGKey(0)))
    converted = torch_state_dict_to_variables(gen.state_dict())
    return {col: merge_variables(init[col], converted[col]) for col in ("params", "batch_stats")}


@pytest.fixture(scope="module")
def fenet_state(tmp_path_factory):
    """fenet's training state of the small generator (the port's seeded
    init, random BN statistics, Adam's moments random and its count 3),
    saved by fenet at epoch 1 in both its containers with a best copy, as
    its driver does."""
    model = JaxGenerator(num_points=N_POINTS, **SMALL)
    trainer = JaxTrainer(model, JaxTrainConfig(batch_size=2, num_points=N_POINTS, **SMALL))
    state = trainer.state_from_variables(_port_init_variables(model))
    rng = np.random.RandomState(2)
    adam = state.opt_state[1]
    adam = adam._replace(
        count=jnp.asarray(3, jnp.int32),
        mu=jax.tree_util.tree_map(lambda x: (rng.randn(*x.shape) * 1e-3).astype(x.dtype),
                                  adam.mu),
        nu=jax.tree_util.tree_map(lambda x: (rng.rand(*x.shape) * 1e-6).astype(x.dtype),
                                  adam.nu))
    state = state.replace(opt_state=(state.opt_state[0], adam), batch_stats=jax.tree_util.tree_map(
        lambda x: rng.uniform(0.5, 2.0, x.shape).astype(np.float32), state.batch_stats))
    arrays = fetch_arrays({"params": state.params, "batch_stats": state.batch_stats,
                           "opt_state": state.opt_state})
    root = tmp_path_factory.mktemp("fenet_state")
    ckpt_dir = root / "checkpoints"
    meta = {"epoch": 1, "model_name": str(ckpt_dir), "train_time": 0.25,
            "best_chamfer_loss": 0.125, "best_emd_loss": float("nan")}
    paths = {fmt: jax_save_checkpoint({**arrays, **meta}, True, CAT, str(ckpt_dir), 1, fmt=fmt)
             for fmt in ("flax", "orbax")}
    target = {"params": state.params, "batch_stats": state.batch_stats,
              "opt_state": state.opt_state}
    yield dict(arrays=arrays, meta=meta, paths=paths, ckpt_dir=ckpt_dir, target=target)
    shutil.rmtree(root, ignore_errors=True)


def test_port_reads_fenets_orbax_state_as_its_ckpt(fenet_state):
    """fenet's .orbax and fenet's .ckpt of one training state: the same
    tree from both readers, and the same blob (state_dict, Adam's moments
    and step, the sidecar's scalars) from load_checkpoint, bit for bit."""
    paths = fenet_state["paths"]
    _assert_trees_equal(orbax.load(paths["orbax"]), flax_msgpack.load(paths["flax"]))
    a = checkpoint.load_checkpoint(paths["orbax"])
    b = checkpoint.load_checkpoint(paths["flax"])
    _assert_blobs_equal(a, b)
    assert float(a["optimizer"]["state"][0]["step"]) == 3.0
    assert json.dumps({k: a[k] for k in fenet_state["meta"]}) == json.dumps(fenet_state["meta"])
    names = param_names(a["state_dict"])
    mu = state_dict_from_jax({"params": fenet_state["arrays"]["opt_state"][1].mu})
    assert all(torch.equal(a["optimizer"]["state"][i]["exp_avg"], mu[n])
               for i, n in enumerate(names))
    _assert_blobs_equal(checkpoint.load_checkpoint(
        str(fenet_state["ckpt_dir"] / "model_best.orbax")), a)


def test_fenet_restores_the_ports_orbax(fenet_state, tmp_path):
    """The port's save of fenet's state in the orbax container (and its
    best copy): fenet's load_checkpoint, with a target and without,
    restores fenet's own arrays and sidecar bit for bit; the directory is
    orbax's non-OCDBT layout, uncompressed; saving again replaces it."""
    blob = checkpoint.load_checkpoint(fenet_state["paths"]["orbax"])
    path = checkpoint.save_checkpoint(blob, True, CAT, str(tmp_path), 1, fmt="orbax")
    assert Path(path).name == f"{CAT}_checkpoint_1.orbax" and Path(path).is_dir()
    assert not (Path(path) / ocdbt.MANIFEST).exists()
    meta = json.loads((Path(path) / orbax.METADATA).read_text())
    assert meta["use_ocdbt"] is False and meta["use_zarr3"] is False
    zarrays = [json.loads(p.read_text()) for p in Path(path).glob("*/.zarray")]
    assert zarrays and all(z["compressor"] is None for z in zarrays)
    assert (Path(path + ".json").read_text()
            == Path(fenet_state["paths"]["orbax"] + ".json").read_text())
    target = fenet_state["target"]
    want = jax_load_checkpoint(fenet_state["paths"]["orbax"], target=target)
    for name in (path, str(tmp_path / "model_best.orbax")):
        got = jax_load_checkpoint(name, target=target)
        assert (jax.tree_util.tree_structure({k: got[k] for k in target})
                == jax.tree_util.tree_structure({k: want[k] for k in target}))
        for a, b in zip(jax.tree_util.tree_leaves({k: got[k] for k in target}),
                        jax.tree_util.tree_leaves(fenet_state["arrays"])):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
        assert json.dumps({k: got[k] for k in fenet_state["meta"]}) == json.dumps(
            fenet_state["meta"])
        raw = jax_load_checkpoint(name)
        assert int(raw["opt_state"][1]["count"]) == 3
    stale = Path(path) / "stale.marker"
    stale.write_text("x")
    checkpoint.save_checkpoint(blob, True, CAT, str(tmp_path), 1, fmt="orbax")
    assert not stale.exists() and not list(tmp_path.glob("*.tmp"))
    _assert_blobs_equal(checkpoint.load_checkpoint(str(tmp_path / "model_best.orbax")), blob)


def test_the_ports_orbax_round_trips_with_the_other_containers(tmp_path):
    """A port Adam state through .pth.tar, .ckpt and .orbax: the three load
    back equal (num_batches_tracked, which fenet keeps not, aside)."""
    gen = init_random_(Generator(num_points=N_POINTS, **SMALL), torch.Generator().manual_seed(3))
    names = param_names(gen.state_dict())
    optimizer = {"state": {i: {"step": torch.tensor(4.0), "exp_avg": torch.randn_like(p),
                               "exp_avg_sq": torch.rand_like(p)}
                           for i, (_, p) in enumerate(gen.named_parameters())},
                 "param_groups": [{"params": list(range(len(names)))}]}
    state = {"state_dict": gen.state_dict(), "optimizer": optimizer, "epoch": 4,
             "model_name": "m", "train_time": 2.0, "best_chamfer_loss": 0.5,
             "best_emd_loss": 0.75}
    blobs = {fmt: checkpoint.load_checkpoint(checkpoint.save_checkpoint(
        state, False, "c", str(tmp_path / fmt), 4, fmt=fmt)) for fmt in ("torch", "flax", "orbax")}
    _assert_blobs_equal(blobs["orbax"], blobs["flax"])
    torch_blob = blobs["torch"]
    for key, value in blobs["orbax"]["state_dict"].items():
        assert torch.equal(value, torch_blob["state_dict"][key]), key
    for i, entry in torch_blob["optimizer"]["state"].items():
        for key, value in entry.items():
            assert torch.equal(blobs["orbax"]["optimizer"]["state"][i][key], value), (i, key)
    assert checkpoint.checkpoint_epoch(str(tmp_path / "orbax" / "c_checkpoint_4.orbax")) == 4
    assert checkpoint.latest_checkpoint(str(tmp_path / "orbax"), "c", ".orbax") == str(
        tmp_path / "orbax" / "c_checkpoint_4.orbax")


def _tiny_state(value: float, epoch: int):
    return {"state_dict": {"fc1.weight": torch.full((2, 3), value), "fc1.bias": torch.zeros(2)},
            "optimizer": {"state": {}, "param_groups": [{"params": [0, 1]}]},
            "epoch": epoch}


def test_resume_picks_the_newest_of_three_containers(tmp_path):
    """The highest epoch wins across the three (a periodic .orbax over older
    bests); at equal epochs the configured container's model_best."""
    logger = logging.getLogger("test")
    d = str(tmp_path)
    for value, fmt in ((1.0, "torch"), (2.0, "flax"), (3.0, "orbax")):
        checkpoint.save_checkpoint(_tiny_state(value, 2), True, "c", d, 2, fmt=fmt)
    for fmt, value in (("torch", 1), ("flax", 2), ("orbax", 3)):
        blob = _newest_checkpoint(d, "c", fmt, logger)
        assert float(blob["state_dict"]["fc1.weight"][0, 0]) == value, fmt
    checkpoint.save_checkpoint(_tiny_state(4.0, 3), False, "c", d, 3, fmt="orbax")
    for fmt in ("torch", "flax"):
        blob = _newest_checkpoint(d, "c", fmt, logger)
        assert blob["epoch"] == 3 and float(blob["state_dict"]["fc1.weight"][0, 0]) == 4


def test_train_cli_resumes_the_newest_of_three_containers(fenet_state, tmp_path):
    """fenet's epoch-1 .orbax beside the same category's epoch-0 .pth.tar
    and .ckpt: the port's train CLI resumes the .orbax at epoch 2 and
    writes the orbax container, which fenet restores with Adam's count one
    step on."""
    write_synthetic_shapenet(str(tmp_path), cats=(CAT,), models_per_cat=1, num_points=N_POINTS)
    ckpt_dir = tmp_path / "out" / CAT / "checkpoints"
    shutil.copytree(fenet_state["paths"]["orbax"], ckpt_dir / f"{CAT}_checkpoint_1.orbax")
    shutil.copyfile(fenet_state["paths"]["orbax"] + ".json",
                    ckpt_dir / f"{CAT}_checkpoint_1.orbax.json")
    older = checkpoint.load_checkpoint(fenet_state["paths"]["flax"])
    older = {**older, "epoch": 0,
             "optimizer": {"state": {}, "param_groups": older["optimizer"]["param_groups"]}}
    for fmt in ("torch", "flax"):
        checkpoint.save_checkpoint(older, False, CAT, str(ckpt_dir), 0, fmt=fmt)
    args = [sys.executable, "-m", "fenet_torch.cli.train", "--device", "cpu", "--cats", CAT,
            "--batchSize", "24", *ARCH, "--emd_iters", "50", "--validate_epochs", "2",
            "--nepoch", "2", "--resume", "True", "--ckpt_format", "orbax",
            "--dir_path", str(tmp_path / "out"), "--splits_path", str(tmp_path / "splits"),
            "--data_dir_imgs", str(tmp_path / "ShapeNetRendering"),
            "--data_dir_pcl", str(tmp_path / "ShapeNet_pointclouds")]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    subprocess.run(args, check=True, cwd=REPO, env=env, timeout=600, capture_output=True)
    got = jax_load_checkpoint(str(ckpt_dir / f"{CAT}_checkpoint_2.orbax"),
                              target=fenet_state["target"])
    assert int(got["opt_state"][1].count) == 4  # 3 from the .orbax, one step of 24 views
    assert got["epoch"] == 2 and got["train_time"] > fenet_state["meta"]["train_time"]
    # The restored running best (CD 0.125) is not beaten: no model_best.
    assert got["best_chamfer_loss"] == 0.125 and checkpoint.best_checkpoint(str(ckpt_dir)) is None
    assert not list(ckpt_dir.glob("*_2.pth.tar")) and not list(ckpt_dir.glob("*_2.ckpt"))
    log = (ckpt_dir / "logging.log").read_text()
    assert log.count("[Epoch 1/") == 0 and log.count("[Epoch 2/2]") == 1


# -- the CLIs ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def three_trees(fenet_state, tmp_path_factory):
    """One state's model_best in each container, each alone in its tree's
    checkpoint directory (fenet's .orbax, fenet's .ckpt, the port's
    .pth.tar), and a synthetic ShapeNet tree to evaluate them on."""
    root = tmp_path_factory.mktemp("three_trees")
    write_synthetic_shapenet(str(root / "data"), cats=(CAT,), models_per_cat=1,
                             num_points=N_POINTS)
    blob = checkpoint.load_checkpoint(fenet_state["paths"]["flax"])
    for fmt, suffix in checkpoint.SUFFIXES.items():
        ckpt_dir = root / fmt / CAT / "checkpoints"
        ckpt_dir.mkdir(parents=True)
        src = fenet_state["ckpt_dir"] / f"model_best{suffix}"
        if fmt == "torch":
            checkpoint.save_checkpoint(blob, True, CAT, str(ckpt_dir), 1, fmt="torch")
            (ckpt_dir / f"{CAT}_checkpoint_1.pth.tar").unlink()
        elif fmt == "orbax":
            shutil.copytree(src, ckpt_dir / src.name)
        else:
            shutil.copyfile(src, ckpt_dir / src.name)
        if fmt != "torch":
            shutil.copyfile(str(src) + ".json", str(ckpt_dir / src.name) + ".json")
    yield root
    shutil.rmtree(root, ignore_errors=True)


def test_clis_look_up_pth_tar_then_ckpt_then_orbax(three_trees, tmp_path):
    """best_checkpoint, require_checkpoints and record_goldens take
    model_best.pth.tar, then .ckpt, then .orbax; a directory without any
    is a usage error naming all three."""
    d = str(tmp_path)
    assert checkpoint.best_checkpoint(d) is None
    checkpoint.save_checkpoint(_tiny_state(1.0, 1), True, "c", d, 1, fmt="orbax")
    assert checkpoint.best_checkpoint(d) == str(tmp_path / "model_best.orbax")
    checkpoint.save_checkpoint(_tiny_state(1.0, 1), True, "c", d, 1, fmt="flax")
    assert checkpoint.best_checkpoint(d) == str(tmp_path / "model_best.ckpt")
    checkpoint.save_checkpoint(_tiny_state(1.0, 1), True, "c", d, 1, fmt="torch")
    assert checkpoint.best_checkpoint(d) == str(tmp_path / "model_best.pth.tar")
    pattern = str(three_trees / "orbax" / "%s" / "checkpoints")
    want = str(three_trees / "orbax" / CAT / "checkpoints" / "model_best.orbax")
    parser = argparse.ArgumentParser()
    assert common.require_checkpoints(parser, pattern, [CAT]) == {CAT: want}
    assert record_goldens.checkpoint_path(argparse.Namespace(torch_model=None, model=pattern),
                                          CAT) == want
    with pytest.raises(SystemExit):
        common.require_checkpoints(parser, pattern, ["absent"])


def test_eval_shapenet_from_model_best_orbax(three_trees):
    """eval_shapenet on a tree holding only fenet's model_best.orbax: the
    metrics of the trees holding only model_best.ckpt or model_best.pth.tar,
    to the bit."""
    data = three_trees / "data"
    metrics = {}
    for fmt in checkpoint.SUFFIXES:
        res = eval_shapenet.main([
            *ARCH, "--batchSize", "8", "--cats", CAT, "--device", "cpu",
            "--model", str(three_trees / fmt / "%s" / "checkpoints"),
            "--splits_path", str(data / "splits"),
            "--data_dir_imgs", str(data / "ShapeNetRendering"),
            "--data_dir_pcl", str(data / "ShapeNet_pointclouds")])[CAT]
        metrics[fmt] = {k: res[k] for k in ("ChamferDistance", "EMD_distance", "samples")}
    assert metrics["orbax"]["samples"] > 0 and np.isfinite(metrics["orbax"]["ChamferDistance"])
    assert metrics["orbax"] == metrics["flax"] == metrics["torch"]


def test_export_deploy_from_orbax(three_trees, tmp_path):
    """export_deploy from a .orbax directory, given as the directory or
    found in its checkpoint dir: the same deploy bytes as from the .ckpt,
    written beside the input by default; load_deploy_checkpoint serves an
    orbax directory of the folded tree as it serves the .ckpt."""
    orbax_dir = three_trees / "orbax" / CAT / "checkpoints"
    outs = {}
    for name, model in (("ckpt", str(three_trees / "flax" / "%s" / "checkpoints")),
                        ("orbax_dir", str(orbax_dir / "model_best.orbax") + "/"),
                        ("orbax_pattern", str(three_trees / "orbax" / "%s" / "checkpoints"))):
        outs[name] = export_deploy.main(["--model", model, "--category", CAT, *ARCH,
                                         "--device", "cpu", "--format", "flax",
                                         "--out", str(tmp_path / f"{name}.ckpt")])
    for name in ("orbax_dir", "orbax_pattern"):
        assert Path(outs[name]).read_bytes() == Path(outs["ckpt"]).read_bytes()
        meta = json.loads(Path(outs[name] + ".json").read_text())
        assert meta["source"] == str(orbax_dir / "model_best.orbax")
    default = export_deploy.main(["--model", str(orbax_dir / "model_best.orbax"), "--category",
                                  CAT, *ARCH, "--device", "cpu", "--format", "torch"])
    assert default == str(orbax_dir / "model_deploy.pth")
    os.remove(default)
    os.remove(default + ".json")
    deploy_orbax = str(tmp_path / "model_deploy.orbax")
    orbax.dump(flax_msgpack.load(outs["ckpt"]), deploy_orbax)
    shutil.copyfile(outs["ckpt"] + ".json", deploy_orbax + ".json")
    a, dtype_a = export_deploy.load_deploy_checkpoint(deploy_orbax, "cpu")
    b, dtype_b = export_deploy.load_deploy_checkpoint(outs["ckpt"], "cpu")
    assert dtype_a == dtype_b == torch.float32 and a.deploy
    for key, value in b.state_dict().items():
        assert torch.equal(a.state_dict()[key], value), key


# -- zstd's absence, the committed fixture, no orbax on the card -----------------------

def test_fenets_orbax_without_libzstd_raises_naming_it(fenet_state, tmp_path, monkeypatch):
    """With libzstd.so.1 unloadable, fenet's (compressed) .orbax raises and
    names it; the port's own .orbax, .ckpt and .pth.tar need no zstd."""
    blob = checkpoint.load_checkpoint(fenet_state["paths"]["flax"])
    paths = [checkpoint.save_checkpoint(blob, False, CAT, str(tmp_path), 1, fmt=fmt)
             for fmt in checkpoint.SUFFIXES]
    real = ctypes.CDLL

    def no_zstd(name, *args, **kwargs):
        if name == zstd.SONAME:
            raise OSError(f"{name}: cannot open shared object file: No such file or directory")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(ctypes, "CDLL", no_zstd)
    zstd._lib.cache_clear()
    try:
        assert not zstd.available()
        with pytest.raises(RuntimeError, match="libzstd.so.1"):
            checkpoint.load_checkpoint(fenet_state["paths"]["orbax"])
        for path in paths:
            _assert_blobs_equal(checkpoint.load_checkpoint(path), blob)
    finally:
        monkeypatch.undo()
        zstd._lib.cache_clear()
    assert zstd.available()


def test_committed_fixture_reads_to_its_seeded_arrays():
    """tests/fixtures/fenet_orbax, written by fenet: every leaf equals
    make_orbax_fixture.seeded_tree() bit for bit, the sidecar its scalars;
    its store keeps values inline and indirect, and its kernel's frame has
    several blocks with Huffman-coded literals."""
    path = str(make_orbax_fixture.CHECKPOINT)
    _assert_trees_equal(orbax.load(path), make_orbax_fixture.seeded_tree())
    meta = json.loads(Path(path + ".json").read_text())
    assert json.dumps(meta) == json.dumps(make_orbax_fixture.META)
    store = ocdbt.Store(path)
    kinds = _kinds(store)
    assert kinds["params.dense.kernel/0.0"] == "indirect"
    assert kinds["params.norm.bias/0"] == "inline"
    blocks = _zstd_blocks(bytes(store.read("params.dense.kernel/0.0")))
    assert len(blocks) >= 2 and (2, 2) in blocks, blocks
    total = sum(f.stat().st_size for f in make_orbax_fixture.FIXTURE.rglob("*") if f.is_file())
    assert total < 2 << 20


def test_port_reads_orbax_with_orbax_tensorstore_jax_and_fenet_blocked(tmp_path):
    """In a process where orbax, tensorstore, zarr, zstandard, JAX, flax and
    fenet cannot be imported: every fenet_torch module imports, the
    committed fixture loads to its seeded arrays, and a port .orbax round
    trips."""
    code = f"""
import sys
for name in ("orbax", "tensorstore", "zarr", "zstandard", "numcodecs", "msgpack", "flax",
             "jax", "jaxlib", "optax", "fenet", "ml_dtypes"):
    sys.modules[name] = None
import importlib, pkgutil
import numpy as np, torch
import fenet_torch
for m in pkgutil.walk_packages(fenet_torch.__path__, "fenet_torch."):
    importlib.import_module(m.name)
sys.path.insert(0, "tests")
import make_orbax_fixture as fx
from fenet_torch.train import orbax
got, want = orbax.load(str(fx.CHECKPOINT)), fx.seeded_tree()
def leaves(t, p=()):
    if isinstance(t, dict):
        for k in t:
            yield from leaves(t[k], p + (k,))
    else:
        yield p, t
pairs = list(zip(leaves(got), leaves(want)))
assert len(pairs) == 19 and all(a[0] == b[0] for a, b in pairs)
for (_, a), (_, b) in pairs:
    a = a.view(torch.int16).numpy() if isinstance(a, torch.Tensor) else a
    assert a.tobytes() == b.tobytes()
orbax.dump(got, {str(tmp_path / "t.orbax")!r})
again = orbax.load({str(tmp_path / "t.orbax")!r})
assert [p for p, _ in leaves(again)] == [p for p, _ in leaves(got)]
print("ok", len(pairs))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["ok", "19"]
