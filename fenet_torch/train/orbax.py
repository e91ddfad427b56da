"""fenet's orbax checkpoint container without orbax or tensorstore: a
PyTree checkpoint directory (``fenet/train/checkpoint.py``'s
``fmt="orbax"``).

A directory holds ``_METADATA`` (JSON: ``tree_metadata`` maps each leaf's
path, written as a Python tuple of its keys, to the keys' kinds, 2 a dict
key and 1 a sequence index, and to the leaf's ``value_type``; and the flags
``use_ocdbt`` and ``use_zarr3``), ``_CHECKPOINT_METADATA`` (JSON: the
handler and timestamps), and one zarr v2 array per leaf named by its keys
joined with dots (:mod:`fenet_torch.train.zarr2`). fenet's own writes keep
the arrays in a tensorstore OCDBT store in the directory
(``manifest.ocdbt``, :mod:`fenet_torch.train.ocdbt`), their chunks
zstd-compressed; orbax's other layout keeps each array as files under
``<dotted.key>/``.

:func:`load` reads either layout into the nested dict that
:func:`fenet_torch.train.flax_msgpack.load` returns for the same state:
sequences as ``"0"``, ``"1"``, ... keys, an empty node (``value_type``
``None``, an empty ``Dict``, ``List`` or ``Tuple``) as ``{}`` (optax's
``EmptyState`` becomes ``{"0": {}, "1": {"count", "mu", "nu"}}``), arrays
as numpy arrays (a 0-d leaf 0-d, bfloat16 as ``torch.bfloat16``) and a
``scalar`` leaf as a Python scalar, keys sorted. :func:`dump` writes
orbax's non-OCDBT layout, one uncompressed chunk per array, which fenet's
``load_checkpoint`` restores: a dict whose keys are exactly ``"0"`` to
``"n-1"`` is written as a sequence (optax's chain state is a tuple in
fenet's tree).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Iterator, List, Tuple

from fenet_torch.train import ocdbt, zarr2

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.pytree_checkpoint_handler."
           "PyTreeCheckpointHandler")
KEY_SEQUENCE, KEY_DICT = 1, 2
ARRAY_TYPES = ("np.ndarray", "jax.Array")
EMPTY_TYPES = ("None", "Dict", "List", "Tuple")


def is_container(path: str) -> bool:
    """Whether ``path`` is an orbax checkpoint directory."""
    return os.path.isfile(os.path.join(path, METADATA))


def _source(path: str):
    if os.path.isfile(os.path.join(path, ocdbt.MANIFEST)):
        return ocdbt.Store(path)
    return zarr2.Directory(path)


def _sorted(tree):
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


def load(path: str) -> Dict[str, Any]:
    """The tree of the orbax checkpoint directory ``path``."""
    if not is_container(path):
        raise FileNotFoundError(f"{path} holds no {METADATA}: not an orbax checkpoint")
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr v3 arrays (use_zarr3) are not read, only zarr v2")
    source = _source(path)
    tree: Dict[str, Any] = {}
    for name, entry in meta["tree_metadata"].items():
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        if kind in EMPTY_TYPES:
            if not entry["value_metadata"].get("skip_deserialize"):
                raise ValueError(f"{path}: {name} is a non-empty {kind} without arrays")
            value = {}
        elif kind in ARRAY_TYPES or kind == "scalar":
            value = zarr2.read_array(source, ".".join(keys))
            if kind == "scalar":
                value = value.item()
        else:
            raise ValueError(f"{path}: {name} has value_type {kind!r}, which is not read")
        node = tree
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = value
    return _sorted(tree)


def _leaves(tree, prefix: Tuple[Tuple[str, int], ...] = ()) -> Iterator[Tuple[tuple, Any]]:
    """(((key, key_type), ...), leaf) of every leaf and empty dict."""
    if isinstance(tree, dict):
        if not tree:
            yield prefix, tree
            return
        kind = KEY_SEQUENCE if sorted(tree) == sorted(map(str, range(len(tree)))) \
            else KEY_DICT
        for key in sorted(tree, key=int if kind == KEY_SEQUENCE else str):
            if not isinstance(key, str):
                raise TypeError(f"orbax tree keys must be str, got {key!r}")
            yield from _leaves(tree[key], prefix + ((key, kind),))
        return
    yield prefix, tree


def _write_json(obj, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f)


def dump(tree: Dict[str, Any], path: str) -> int:
    """Write ``tree`` (nested str-keyed dicts of numpy arrays or tensors)
    as an orbax checkpoint directory at ``path``, through ``<path>.tmp``
    renamed into place (an existing ``path`` is removed first, as fenet
    does). Returns the bytes of the arrays' chunks."""
    init_ns = time.time_ns()
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    tree_metadata: Dict[str, Any] = {}
    nbytes = 0
    for keys, leaf in _leaves(tree):
        if not keys:
            raise ValueError("an orbax checkpoint's root must be a non-empty dict")
        names: List[str] = [k for k, _ in keys]
        if isinstance(leaf, dict):
            value = {"value_type": "Dict", "skip_deserialize": True}
        else:
            nbytes += zarr2.write_array(tmp, ".".join(names), leaf)
            value = {"value_type": "np.ndarray", "skip_deserialize": False}
        tree_metadata[str(tuple(names))] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
            "value_metadata": value}
    _write_json({"tree_metadata": tree_metadata, "use_ocdbt": False, "use_zarr3": False,
                 "store_array_data_equal_to_fill_value": True, "custom_metadata": None},
                os.path.join(tmp, METADATA))
    _write_json({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                 "init_timestamp_nsecs": init_ns, "commit_timestamp_nsecs": time.time_ns(),
                 "custom_metadata": {}}, os.path.join(tmp, CHECKPOINT_METADATA))
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    return nbytes
