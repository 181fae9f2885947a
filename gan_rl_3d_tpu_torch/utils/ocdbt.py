"""Read-only OCDBT key-value store, the layout orbax writes its arrays in.

tensorstore's OCDBT key-value store keeps a B-tree of keys under one
directory:

* ``manifest.ocdbt``: the configuration and the versions; the newest
  version names the B-tree's root node.
* B-tree nodes and values live in data files (``d/<name>``, or
  ``ocdbt.process_N/d/<name>`` where several processes wrote), addressed
  by (data file, offset, length). A node's keys are prefix-compressed
  against the one before; an interior node's entry also names the
  prefix that every key of its subtree shares, which the subtree's own
  keys leave out. A value is stored inline in its leaf, or in a data
  file.

A manifest or node is a 14-byte header (the magic ``0c db 3a 2a`` or
``0c db 20 de``, the file's length as 8 bytes little-endian, the format
version as a varint, the compression as a varint: 0 none, 1 zstd), the
body, and a CRC-32C of all that came before. ``OcdbtStore`` checks each,
and refuses a numbered manifest, an unknown version or compression with a
``ValueError`` that names it. No orbax or tensorstore is needed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

from gan_rl_3d_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_HEADER = 14


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def varint(self) -> int:
        out = shift = 0
        while True:
            if self.pos >= len(self.data):
                raise ValueError(f"ocdbt: {self.what} ends inside a varint")
            c = self.data[self.pos]
            self.pos += 1
            out |= (c & 0x7F) << shift
            shift += 7
            if c < 0x80:
                return out

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def byte(self) -> int:
        self.pos += 1
        if self.pos > len(self.data):
            raise ValueError(f"ocdbt: {self.what} is truncated")
        return self.data[self.pos - 1]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"ocdbt: {self.what} is truncated")
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _body(blob: bytes, magic: int, what: str) -> _Reader:
    """The checked, decompressed body of a manifest or node."""
    if len(blob) < _HEADER + 4 or int.from_bytes(blob[:4], "big") != magic:
        raise ValueError(f"ocdbt: {what} has the wrong magic number")
    if int.from_bytes(blob[4:12], "little") != len(blob):
        raise ValueError(f"ocdbt: {what} length field disagrees with its "
                         "size")
    head = _Reader(blob[12:_HEADER], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what} has format version {version}; "
                         "only version 0 is read")
    if crc32c(blob[:-4]) != int.from_bytes(blob[-4:], "little"):
        raise ValueError(f"ocdbt: {what} fails its CRC-32C check")
    body = blob[head.pos + 12:-4]
    if compression == 1:
        body = zstd.decompress(body)
    elif compression != 0:
        raise ValueError(f"ocdbt: {what} uses compression {compression}; "
                         "only none (0) and zstd (1) are read")
    return _Reader(body, what)


def _data_files(r: _Reader) -> List[str]:
    """A data file table: each path is base path + relative path, kept
    as the prefix it shares with the path before and its suffix."""
    n = r.varint()
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # base path lengths; the full path is what we need
    paths, prev = [], b""
    for i in range(n):
        path = prev[:shared[i]] + r.raw(suffix[i])
        name = path.decode()
        if name.startswith("/") or ".." in name.split("/"):
            raise ValueError(f"ocdbt: data file {name!r} lies outside the "
                             "checkpoint")
        paths.append(name)
        prev = path
    return paths


def _keys(r: _Reader, n: int, with_subtree_prefix: bool
          ) -> Tuple[List[bytes], List[int]]:
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if with_subtree_prefix else []
    keys, prev = [], b""
    for i in range(n):
        key = prev[:shared[i]] + r.raw(suffix[i])
        keys.append(key)
        prev = key
    return keys, common


class OcdbtStore:
    """The newest version of the OCDBT database under ``root``:
    ``list_keys()`` and ``read(key)``."""

    def __init__(self, root: "str | Path"):
        self.root = Path(root)
        manifest = self.root / "manifest.ocdbt"
        if not manifest.exists():
            raise ValueError(f"{self.root} holds no OCDBT manifest")
        r = _body(manifest.read_bytes(), MANIFEST_MAGIC, "manifest")
        r.raw(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError("ocdbt: numbered manifests are not read; only "
                             "a single manifest.ocdbt")
        r.varint()  # max inline value bytes
        r.varint()  # max decoded node bytes
        r.byte()  # version tree arity log2
        if r.varint() == 1:
            r.raw(4)  # zstd level
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            self._root = None
        else:
            r.varints(n)  # generation numbers
            heights = [r.byte() for _ in range(n)]
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            num_keys = r.varints(n)
            self._root = (files[ids[-1]], offsets[-1], lengths[-1],
                          heights[-1]) if num_keys[-1] else None
        self._files: Dict[str, bytes] = {}
        self._entries = None

    def _blob(self, path: str, offset: int, length: int) -> bytes:
        if path not in self._files:
            self._files[path] = (self.root / path).read_bytes()
        data = self._files[path]
        if offset + length > len(data):
            raise ValueError(f"ocdbt: {path} is shorter than a reference "
                             "into it")
        return data[offset:offset + length]

    def _walk(self, ref, prefix: bytes, out: Dict[bytes, object]) -> None:
        path, offset, length, height = ref
        r = _body(self._blob(path, offset, length), NODE_MAGIC,
                  f"B-tree node {path}@{offset}")
        if r.byte() != height:
            raise ValueError("ocdbt: a B-tree node's height disagrees with "
                             "its reference")
        files = _data_files(r)
        n = r.varint()
        if height:
            keys, common = _keys(r, n, True)
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for key, c, i, o, ln in zip(keys, common, ids, offsets, lengths):
                self._walk((files[i], o, ln, height - 1), prefix + key[:c],
                           out)
            return
        keys, _ = _keys(r, n, False)
        lengths = r.varints(n)
        kinds = r.varints(n)
        n_out = sum(kinds)
        if any(k > 1 for k in kinds):
            raise ValueError("ocdbt: unknown value kind in a leaf")
        ids, offsets = r.varints(n_out), r.varints(n_out)
        indirect = iter(zip(ids, offsets))
        for key, ln, kind in zip(keys, lengths, kinds):
            if kind:
                i, o = next(indirect)
                out[prefix + key] = (files[i], o, ln)
            else:
                out[prefix + key] = r.raw(ln)

    def _all(self) -> Dict[bytes, object]:
        if self._entries is None:
            self._entries = {}
            if self._root is not None:
                self._walk(self._root, b"", self._entries)
        return self._entries

    def list_keys(self) -> List[str]:
        return sorted(k.decode() for k in self._all())

    def read(self, key: str) -> bytes:
        """The value of ``key``; KeyError when it is absent."""
        value = self._all()[key.encode()]
        if isinstance(value, tuple):
            return self._blob(*value)
        return value
