"""A read-only reader of tensorstore's OCDBT key-value store (its "OCDBT
storage format"), the store of fenet's orbax checkpoints.

A store is a directory. ``manifest.ocdbt`` holds the store's configuration
and its versions; each version names the root of a b-tree whose leaves map
byte-string keys to values. Every manifest and b-tree node is one encoded
object (``<magic u32be> <length u64le> <version varint> <compression
varint> <body> <crc32c u32le>``) where the body may be one zstd frame, and
the CRC-32C covers every byte before it. Nodes and values live in data
files, which a node names through its data-file table as ``(base path,
relative path)``, both relative to the store's root; a node read from a
data file with base path ``B`` reads its own table's base paths under
``B``. A leaf's value is inline in the node or indirect: (data file,
offset, length). orbax writes one store per process (``ocdbt.process_<i>/``,
each readable on its own) and merges their trees into the root's store,
whose nodes name the per-process data files.

:meth:`Store.list` gives every key of the newest version with its value's
length, and :meth:`Store.read` a value: an inline one as bytes of the
decoded node, an indirect one as a view of a read-only ``mmap`` of its data
file, so a large value is not copied before it is decoded. Only the
single-file manifest (orbax's) is read; the numbered kind raises.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER_BYTES = 12  # magic u32be, total length u64le
COMPRESSION_NONE, COMPRESSION_ZSTD = 0, 1
VALUE_INLINE, VALUE_INDIRECT = 0, 1


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli, reflected polynomial 0x82F63B78)."""
    c = 0xFFFFFFFF
    table = _CRC32C
    for byte in memoryview(data).cast("B"):
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    """Reads the fields of a decoded body."""

    def __init__(self, data, what: str):
        self.data = memoryview(data).cast("B")
        self.pos = 0
        self.what = what

    def fail(self, why: str):
        raise ValueError(f"OCDBT {self.what}: {why} at byte {self.pos}")

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            self.fail(f"truncated ({n} bytes wanted)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.byte()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes after the end")


def decode_object(buf, magic: int, what: str) -> memoryview:
    """The body of an encoded manifest or node, its header, length and
    CRC-32C checked and its zstd frame decoded."""
    data = memoryview(buf).cast("B")
    if len(data) < _HEADER_BYTES + 4:
        raise ValueError(f"OCDBT {what}: {len(data)} bytes is too short")
    (got_magic,), (length,) = struct.unpack_from(">I", data), struct.unpack_from("<Q", data, 4)
    if got_magic != magic:
        raise ValueError(f"OCDBT {what}: magic 0x{got_magic:08x}, not 0x{magic:08x}")
    if length != len(data):
        raise ValueError(f"OCDBT {what}: the header says {length} bytes, found {len(data)}")
    (crc,) = struct.unpack_from("<I", data, len(data) - 4)
    if crc32c(data[:-4]) != crc:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    head = _Cursor(data[:-4], what)
    head.pos = _HEADER_BYTES
    version = head.varint()
    if version != 0:
        head.fail(f"format version {version} is not 0")
    compression = head.varint()
    body = data[head.pos:-4]
    if compression == COMPRESSION_NONE:
        return body
    if compression == COMPRESSION_ZSTD:
        from fenet_torch.native import zstd

        return memoryview(zstd.decompress(body))
    head.fail(f"compression {compression} is neither none (0) nor zstd (1)")


@dataclass(frozen=True)
class DataFile:
    base_path: str
    relative_path: str

    @property
    def path(self) -> str:
        return self.base_path + self.relative_path


@dataclass(frozen=True)
class Ref:
    """A range of a data file: a node, or an indirect value."""

    file: DataFile
    offset: int
    length: int


def _data_file_table(cur: _Cursor, parent_base: str) -> List[DataFile]:
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base = cur.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            cur.fail("a data-file path's prefix is longer than the previous path")
        full = prev[:prefix[i]] + bytes(cur.take(suffix[i]))
        if base[i] > len(full):
            cur.fail("a data-file base path is longer than its path")
        path = full.decode()
        files.append(DataFile(parent_base + path[:base[i]], path[base[i]:]))
        prev = full
    return files


def _refs(cur: _Cursor, files: List[DataFile], n: int, lengths: Optional[List[int]] = None
          ) -> List[Ref]:
    ids = cur.varints(n)
    offsets = cur.varints(n)
    if lengths is None:
        lengths = cur.varints(n)
    if any(i >= len(files) for i in ids):
        cur.fail("a data-file index outside the table")
    return [Ref(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _keys(cur: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """A node's prefix-compressed keys and, in an interior node, each
    subtree's common prefix length (read between the key lengths and the
    key bytes)."""
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            cur.fail("a key's prefix is longer than the previous key")
        prev = prev[:prefix[i]] + bytes(cur.take(suffix[i]))
        keys.append(prev)
    return keys, common


@dataclass(frozen=True)
class Config:
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int
    zstd_level: Optional[int]


@dataclass(frozen=True)
class Version:
    generation: int
    height: int
    root: Optional[Ref]  # None: an empty tree
    num_keys: int
    commit_time_ns: int


def parse_manifest(buf) -> Tuple[Config, List[Version]]:
    """The configuration and the manifest's own version entries (which hold
    the newest version) of a single-file manifest."""
    cur = _Cursor(decode_object(buf, MANIFEST_MAGIC, "manifest"), "manifest")
    uuid = bytes(cur.take(16))
    kind, max_inline, max_node = cur.varint(), cur.varint(), cur.varint()
    arity = cur.byte()
    compression = cur.varint()
    level = None
    if compression == COMPRESSION_ZSTD:
        (level,) = struct.unpack("<i", cur.take(4))
    elif compression != COMPRESSION_NONE:
        cur.fail(f"node compression {compression} is neither none nor zstd")
    config = Config(uuid, kind, max_inline, max_node, arity, compression, level)
    if kind != 0:
        raise ValueError("OCDBT manifest: only the single-file manifest kind (0) is read, "
                         f"this store's is {kind}")
    files = _data_file_table(cur, "")
    n = cur.varint()
    generations = cur.varints(n)
    heights = [cur.byte() for _ in range(n)]
    roots = _refs(cur, files, n)
    num_keys = cur.varints(n)
    cur.varints(n)  # num_tree_bytes
    cur.varints(n)  # num_indirect_value_bytes
    times = [struct.unpack("<Q", cur.take(8))[0] for _ in range(n)]
    # The version-tree nodes that follow index older versions only.
    return config, [Version(g, h, r if k else None, k, t) for g, h, r, k, t in
                    zip(generations, heights, roots, num_keys, times)]


@dataclass
class Entry:
    """A leaf entry: an inline value's bytes, or an indirect value's ref."""

    key: bytes
    length: int
    inline: Optional[memoryview] = None
    ref: Optional[Ref] = None


class Store:
    """The newest version of an OCDBT store at ``root`` (a directory)."""

    def __init__(self, root: str):
        self.root = str(root)
        self._maps: Dict[str, mmap.mmap] = {}
        self._entries: Dict[bytes, Entry] = {}
        manifest = os.path.join(self.root, MANIFEST)
        if not os.path.isfile(manifest):
            raise FileNotFoundError(f"{self.root} holds no {MANIFEST}: not an OCDBT store")
        with open(manifest, "rb") as f:
            self.config, versions = parse_manifest(f.read())
        newest = max(versions, key=lambda v: v.generation, default=None)
        if newest is not None and newest.root is not None:
            self._walk(newest.root, newest.height, b"")

    def _mapped(self, file: DataFile) -> mmap.mmap:
        m = self._maps.get(file.path)
        if m is None:
            with open(os.path.join(self.root, file.path), "rb") as f:
                size = os.fstat(f.fileno()).st_size
                m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size else b""
            self._maps[file.path] = m
        return m

    def _range(self, ref: Ref) -> memoryview:
        data = self._mapped(ref.file)
        if ref.offset + ref.length > len(data):
            raise ValueError(f"OCDBT: {ref.file.path} holds {len(data)} bytes, a reference "
                             f"reaches {ref.offset + ref.length}")
        return memoryview(data)[ref.offset:ref.offset + ref.length]

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = f"node {ref.file.path}@{ref.offset}"
        cur = _Cursor(decode_object(self._range(ref), NODE_MAGIC, what), what)
        if cur.byte() != height:
            cur.fail(f"height is not the expected {height}")
        files = _data_file_table(cur, ref.file.base_path)
        n = cur.varint()
        if height == 0:
            keys, _ = _keys(cur, n, interior=False)
            lengths = cur.varints(n)
            kinds = [cur.byte() for _ in range(n)]
            if any(k not in (VALUE_INLINE, VALUE_INDIRECT) for k in kinds):
                cur.fail("a value kind is neither inline (0) nor indirect (1)")
            indirect = [i for i, k in enumerate(kinds) if k == VALUE_INDIRECT]
            refs = iter(_refs(cur, files, len(indirect), [lengths[i] for i in indirect]))
            for key, length, kind in zip(keys, lengths, kinds):
                entry = Entry(prefix + key, length)
                if kind == VALUE_INDIRECT:
                    entry.ref = next(refs)
                else:
                    entry.inline = cur.take(length)
                self._entries[entry.key] = entry
            cur.end()
            return
        keys, common = _keys(cur, n, interior=True)
        children = _refs(cur, files, n)
        cur.varints(n)  # num_keys
        cur.varints(n)  # num_tree_bytes
        cur.varints(n)  # num_indirect_value_bytes
        cur.end()
        for key, keep, child in zip(keys, common, children):
            if keep > len(key):
                cur.fail("a subtree's common prefix is longer than its key")
            self._walk(child, height - 1, prefix + key[:keep])

    def list(self) -> Iterator[Tuple[str, int]]:
        """(key, value length) of every key, in key order."""
        for key in sorted(self._entries):
            yield key.decode(), self._entries[key].length

    def read(self, key: str) -> memoryview:
        """A key's value: inline bytes, or a view of its data file's mapping.
        A missing key raises KeyError."""
        entry = self._entries[key.encode()]
        return entry.inline if entry.ref is None else self._range(entry.ref)
