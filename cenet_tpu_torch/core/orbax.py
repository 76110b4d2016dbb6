"""A reader of the JAX package's Orbax checkpoints that imports no JAX.

The JAX package saves every tag and step as an Orbax ``StandardSave`` of its
whole TrainState (``cenet_tpu/core/checkpoint.py:31-121``). Reading one back
with ``orbax.checkpoint`` imports JAX, which the port never does, and the card's
machine has neither JAX nor ``tensorstore`` nor ``zstandard``. This module reads
the on-disk format itself, in three layers:

1. **OCDBT**, TensorStore's key-value database. ``manifest.ocdbt`` holds the
   database's config and its versions; the latest version names the root of
   a B+tree whose nodes live in data files under ``d/`` (or
   ``ocdbt.process_<i>/d/``, named relative to the database's root through
   each node's data-file table). Every manifest and node is a header (magic
   number, length, format version, compression), a body, and a CRC-32C of all
   that precedes it; the body is one zstd frame when compressed. Interior
   nodes hold prefix-compressed keys with their subtrees' common prefixes and
   references (file, offset, length) to their children; leaf nodes hold
   prefix-compressed keys and values, inline or as references into a data
   file. All integers but the fixed headers are LEB128 varints, stored column
   by column.
2. **zarr v2**, one array per leaf under the key ``<path joined by '.'>``:
   ``<name>/.zarray`` (JSON: shape, chunks, dtype, ``fill_value``, and as
   Orbax writes them C order, ``'.'`` between chunk indices and the zstd
   compressor) and one zstd-compressed C-order chunk per grid cell,
   ``<name>/<i>.<j>…`` (``<name>/0`` for a 0-d array). A chunk that is absent
   reads as ``fill_value``.
3. **``_METADATA``** (JSON), Orbax's tree: each leaf's key path with its key
   types (1 a sequence index, 2 a dict key) and value type. Leaves written as
   ``None`` or as empty containers carry ``skip_deserialize`` and no array.

:func:`read_checkpoint` returns the tree as Orbax's own restore without a
target returns it: dicts for dict keys and for namedtuple fields, lists for
sequences, ``None`` and empty containers as written, numpy arrays for arrays.
The zstd frames are decoded by the port's own decoder
(:func:`cenet_tpu_torch.native.zstd_decompress`) and the checksums checked by
its CRC-32C. A layout outside this one (zarr v3, another compressor or codec,
a numbered manifest, a value type it does not know) raises ``ValueError``
naming what it met; a truncated file or a checksum that disagrees raises too.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from cenet_tpu_torch.native import crc32c, zstd_decompress

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_NODE_MAGIC = 0x0CDB20DE
NO_ROOT = (1 << 64) - 1  # the root offset of an empty tree
# Orbax's tree metadata key types (orbax.checkpoint tree_metadata KeyType)
KEY_SEQUENCE, KEY_DICT = 1, 2
ARRAY_VALUE_TYPES = ("np.ndarray", "jax.Array")
EMPTY_VALUES = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}


def is_orbax_checkpoint(path: str) -> bool:
    """Whether ``path`` is one Orbax checkpoint of the JAX package: a tag
    directory (``_METADATA`` beside ``manifest.ocdbt``) or a step directory
    (``<n>/default/…``)."""
    return _item_dir(path) is not None


def _item_dir(path: str) -> Optional[str]:
    """The directory that holds the tree's ``_METADATA``: ``path`` itself for
    a tag, ``path/default`` for a step; None when ``path`` is neither."""
    for d in (path, os.path.join(path, "default")):
        if os.path.isfile(os.path.join(d, "_METADATA")):
            return d
    return None


class _Cursor:
    """Reads the fields of one decoded body, raising ``ValueError`` at its end."""

    def __init__(self, data, what: str):
        self.data = data
        self.pos = 0
        self.what = what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated")
        b = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return b

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            c = self.byte()
            v |= (c & 0x7F) << shift
            if c < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def done(self):
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} bytes left over")


def _unframe(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file: header, checksum and compression checked."""
    if len(raw) < 4 + 8 + 2 + 4:
        raise ValueError(f"{what}: {len(raw)} bytes, shorter than a header")
    got_magic, length = struct.unpack_from(">I", raw)[0], struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{what}: magic number {got_magic:#010x}, expected {magic:#010x}")
    if length != len(raw):
        raise ValueError(f"{what}: header says {length} bytes, found {len(raw)}")
    (want_crc,) = struct.unpack_from("<I", raw, len(raw) - 4)
    if crc32c(raw[:-4]) != want_crc:
        raise ValueError(f"{what}: CRC-32C mismatch")
    head = _Cursor(raw[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} (this reader takes 0)")
    body = raw[12 + head.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decompress(body).tobytes()
    raise ValueError(f"{what}: OCDBT compression format {compression} (this reader takes 0 and 1, zstd)")


def _data_file_table(c: _Cursor) -> List[str]:
    """The node's data files, paths relative to the database's root (each the
    previous path's first ``prefix`` characters, then its own suffix)."""
    n = c.varint()
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    c.varints(n)  # where each path's base part ends: the full path is base + relative either way
    paths: List[str] = []
    for i in range(n):
        prev = paths[-1] if paths else ""
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: data file prefix longer than the previous path")
        paths.append(prev[:prefix[i]] + c.take(suffix[i]).decode())
    return paths


def _keys(c: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + c.varints(max(n - 1, 0))
    suffix = c.varints(n)
    common = c.varints(n) if interior else [0] * n
    keys: List[bytes] = []
    for i in range(n):
        prev = keys[-1] if keys else b""
        if prefix[i] > len(prev):
            raise ValueError(f"{c.what}: key prefix longer than the previous key")
        keys.append(prev[:prefix[i]] + c.take(suffix[i]))
    return keys, common


class OcdbtDatabase:
    """The latest version of one OCDBT database (a directory holding
    ``manifest.ocdbt``), read into ``{key: value}``; indirect values stay
    references until :meth:`get` reads them."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._files: Dict[str, Any] = {}
        try:
            self.entries = self._read()
        finally:
            self.close()

    # -- files ------------------------------------------------------------------

    def _path(self, rel: str) -> str:
        p = os.path.abspath(os.path.join(self.root, rel))
        if not p.startswith(self.root + os.sep):
            raise ValueError(f"OCDBT data file {rel!r} lies outside {self.root}")
        return p

    def _slice(self, rel: str, offset: int, length: int) -> bytes:
        f = self._files.get(rel)
        if f is None:
            f = self._files[rel] = open(self._path(rel), "rb")
        f.seek(offset)
        b = f.read(length)
        if len(b) != length:
            raise ValueError(f"OCDBT data file {rel}: {length} bytes at {offset} run past its end")
        return b

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()

    # -- manifest and tree --------------------------------------------------------

    def _read(self) -> Dict[bytes, Any]:
        path = os.path.join(self.root, "manifest.ocdbt")
        if not os.path.isfile(path):
            raise ValueError(f"no manifest.ocdbt in {self.root}: not an OCDBT database")
        with open(path, "rb") as f:
            c = _Cursor(_unframe(f.read(), MANIFEST_MAGIC, path), path)
        c.take(16)  # the database's uuid
        kind = c.varint()
        if kind != 0:
            raise ValueError(f"{path}: OCDBT manifest kind {kind} (numbered manifests are not read; 0 is)")
        c.varint(), c.varint()  # max inline value bytes, max decoded node bytes
        c.byte()  # version tree arity (log2)
        method = c.varint()  # how new nodes are compressed: 0 none, 1 zstd with its level
        if method == 1:
            c.take(4)
        elif method != 0:
            raise ValueError(f"{path}: OCDBT compression method {method} (0 and 1, zstd, are read)")
        files = _data_file_table(c)
        n = c.varint()
        if n == 0:
            raise ValueError(f"{path}: OCDBT manifest without a version")
        generation = c.varints(n)
        height = [c.byte() for _ in range(n)]
        file_id, offset, length = c.varints(n), c.varints(n), c.varints(n)
        c.varints(3 * n)  # per version: keys, tree bytes, indirect value bytes
        c.take(8 * n)  # commit times
        # older versions' tree nodes follow; the latest version is always inline
        latest = max(range(n), key=generation.__getitem__)
        out: Dict[bytes, Any] = {}
        if offset[latest] != NO_ROOT:
            self._node(files[file_id[latest]], offset[latest], length[latest], height[latest], b"", out)
        return out

    def _node(self, rel: str, offset: int, length: int, height: int, prefix: bytes, out: Dict):
        what = f"OCDBT node {rel}@{offset}"
        c = _Cursor(_unframe(self._slice(rel, offset, length), BTREE_NODE_MAGIC, what), what)
        got_height = c.byte()
        if got_height != height:
            raise ValueError(f"{what}: height {got_height} where its parent says {height}")
        files = _data_file_table(c)
        n = c.varint()
        if height > 0:
            keys, common = _keys(c, n, interior=True)
            file_id, child_off, child_len = c.varints(n), c.varints(n), c.varints(n)
            c.varints(3 * n)  # per child: keys, tree bytes, indirect value bytes
            c.done()
            for i in range(n):
                self._node(files[file_id[i]], child_off[i], child_len[i], height - 1,
                           prefix + keys[i][:common[i]], out)
            return
        keys, _ = _keys(c, n, interior=False)
        lengths = c.varints(n)
        kinds = c.varints(n)
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{what}: value kind {max(kinds)} (0 inline and 1 indirect are read)")
        indirect = [i for i in range(n) if kinds[i] == 1]
        ind_file, ind_off = c.varints(len(indirect)), c.varints(len(indirect))
        refs = {i: (files[f], o) for i, f, o in zip(indirect, ind_file, ind_off)}
        for i in range(n):
            out[prefix + keys[i]] = (*refs[i], lengths[i]) if kinds[i] == 1 else c.take(lengths[i])
        c.done()

    def get(self, key: str) -> Optional[bytes]:
        """The value under ``key``, or None when the database has none."""
        return self.get_many([key])[0]

    def get_many(self, keys: Iterable[str]) -> List[Optional[bytes]]:
        """:meth:`get` of each key, the data files opened once."""
        try:
            out = []
            for key in keys:
                v = self.entries.get(key.encode())
                out.append(self._slice(*v) if isinstance(v, tuple) else v)
            return out
        finally:
            self.close()


# -- zarr v2 --------------------------------------------------------------------------

def _zarr_dtype(spec, name: str) -> np.dtype:
    if not isinstance(spec, str) or len(spec) < 3 or spec[0] not in "<>|" or spec[1] not in "fiub":
        raise ValueError(f"zarr array {name}: dtype {spec!r} is not read (plain numeric dtypes such as '<f4' are)")
    return np.dtype(spec)


def read_zarr_array(db: OcdbtDatabase, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``db``, in native byte order."""
    raw = db.get(f"{name}/.zarray")
    if raw is None:
        if db.get(f"{name}/zarr.json") is not None:
            raise ValueError(f"array {name} is zarr v3 (zarr.json); only zarr v2 (.zarray) is read")
        raise ValueError(f"array {name}: no {name}/.zarray in the checkpoint")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr array {name}: zarr_format {meta.get('zarr_format')!r} (2 is read)")
    comp = (meta.get("compressor") or {}).get("id")
    if comp != "zstd":
        raise ValueError(f"zarr array {name}: compressor {comp!r} (zstd is read)")
    if meta.get("filters"):
        raise ValueError(f"zarr array {name}: filters {meta['filters']!r} (none are read)")
    for key, want in (("order", "C"), ("dimension_separator", ".")):
        if meta.get(key, want) != want:
            raise ValueError(f"zarr array {name}: {key} {meta[key]!r} ({want!r} is read)")
    dtype = _zarr_dtype(meta.get("dtype"), name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"zarr array {name}: chunks {chunks} do not fit shape {shape}")
    fill = meta.get("fill_value")
    fill = 0 if fill is None else fill
    out = np.full(shape, fill, dtype=dtype.newbyteorder("="))
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    cells = list(np.ndindex(*[len(g) for g in grid])) if shape else [()]
    chunk_bytes = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    keys = [f"{name}/{'.'.join(map(str, idx)) if idx else '0'}" for idx in cells]
    for idx, key, data in zip(cells, keys, db.get_many(keys)):
        if data is None:
            continue  # an absent chunk reads as fill_value
        chunk = zstd_decompress(data, size=chunk_bytes).view(dtype).reshape(chunks)
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


# -- the tree ---------------------------------------------------------------------------


def _metadata(item: str) -> Dict:
    with open(os.path.join(item, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{item}: written with zarr v3 (use_zarr3); only zarr v2 is read")
    if "tree_metadata" not in meta:
        raise ValueError(f"{item}/_METADATA has no tree_metadata: not an Orbax PyTree checkpoint this reader knows")
    return meta["tree_metadata"]


def _to_sequences(node):
    """Dicts built for sequence keys → lists, in index order."""
    if isinstance(node, _Seq):
        idx = sorted(node)
        if idx != list(range(len(idx))):
            raise ValueError(f"sequence indices {idx} are not 0..{len(idx) - 1}")
        return [_to_sequences(node[i]) for i in idx]
    if isinstance(node, dict):
        return {k: _to_sequences(v) for k, v in node.items()}
    return node


class _Seq(dict):
    """A sequence under construction: index → child."""


def read_checkpoint(path: str, select: Optional[Iterable[str]] = None) -> Dict:
    """The tree of the Orbax checkpoint at ``path`` (a tag directory, or a step
    directory ``<snap>/steps/<n>`` with its ``default`` item), as Orbax's
    restore without a target gives it. ``select`` names the top-level keys to
    read (say ``("params", "batch_stats")``), each of which must be there; the
    others are left out unread."""
    item = _item_dir(path)
    if item is None:
        raise ValueError(f"{path} is not an Orbax checkpoint (no _METADATA in it or in its default/)")
    tree_meta = _metadata(item)
    select = None if select is None else list(select)
    db: Optional[OcdbtDatabase] = None
    root: Dict = {}
    for entry in tree_meta.values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        if select is not None and keys and keys[0]["key"] not in select:
            continue
        vtype = value.get("value_type")
        if value.get("skip_deserialize"):
            if vtype not in EMPTY_VALUES:
                raise ValueError(f"{item}: leaf {[k['key'] for k in keys]} skipped with value type {vtype!r}")
            leaf = EMPTY_VALUES[vtype]()
        elif vtype in ARRAY_VALUE_TYPES:
            if db is None:
                db = OcdbtDatabase(item)
            leaf = read_zarr_array(db, ".".join(str(k["key"]) for k in keys))
        else:
            raise ValueError(f"{item}: leaf {[k['key'] for k in keys]} has value type {vtype!r}, which is not read")
        node: Dict = root
        for depth, k in enumerate(keys):
            kt = k["key_type"]
            if kt not in (KEY_SEQUENCE, KEY_DICT):
                raise ValueError(f"{item}: key type {kt} (1 sequence, 2 dict are read)")
            key = int(k["key"]) if kt == KEY_SEQUENCE else k["key"]
            if depth == len(keys) - 1:
                node[key] = leaf
                break
            child_type = _Seq if keys[depth + 1]["key_type"] == KEY_SEQUENCE else dict
            node = node.setdefault(key, child_type())
    if select is not None:
        missing = [k for k in select if k not in root]
        if missing:
            held = sorted({e["key_metadata"][0]["key"] for e in tree_meta.values() if e["key_metadata"]})
            raise ValueError(f"{item}: the checkpoint has no {missing} (it holds {held})")
    return _to_sequences(root)
