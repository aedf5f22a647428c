"""A read-only OCDBT key-value store over a directory.

OCDBT ("optionally-cooperative distributed B+tree") is the key-value format
that Orbax writes checkpoints into through tensorstore (``use_ocdbt``). The
layout follows tensorstore's public description of the format:

- ``manifest.ocdbt`` holds the store's config and its versions; the newest
  version names the B+tree's root node.
- Every manifest and node is a 4-byte big-endian magic (``0x0cdb3a2a`` a
  manifest, ``0x0cdb20de`` a node), a little-endian u64 total length, a
  varint format version (0), a varint compression (0 none, 1 zstd), the
  body (one zstd frame when compressed) and a little-endian CRC-32C of
  everything before it.
- A node is its height (a byte; 0 a leaf), a table of the data files it
  points into (prefix-compressed paths, each split into a base path and a
  relative path) and its entries in columns: keys (prefix-compressed), then
  for a leaf each value inline or as (data file, offset, length), for an
  interior node each child's (data file, offset, length) and statistics.
- A data file's path is relative to the directory: the base path of the
  file a node was read from prefixes the paths in that node's table, so the
  top-level tree reaches the ``ocdbt.process_<i>/d/`` files Orbax writes.

Decompression is the host's libzstd (``native.zstd_decompress``) and the
CRC-32C the port's own (``native.crc32c``), so reading needs neither
tensorstore nor a Python zstd package. Every manifest and node read has its
footer checked; a corrupted file raises ``ValueError``.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple, Union

from .. import native

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE

# value: inline bytes, or (data file path, offset, length)
_Value = Union[bytes, Tuple[str, int, int]]


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.b, self.i, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.i + n > len(self.b):
            raise ValueError(f'{self.what}: truncated')

    def byte(self) -> int:
        self._need(1)
        self.i += 1
        return self.b[self.i - 1]

    def take(self, n: int) -> bytes:
        self._need(n)
        self.i += n
        return self.b[self.i - n:self.i]

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            c = self.byte()
            out |= (c & 0x7F) << shift
            if c < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise ValueError(f'{self.what}: varint too long')

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def decode_envelope(data: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node file, its length, version and CRC-32C
    footer checked."""
    if len(data) < 18:
        raise ValueError(f'{what}: truncated')
    got_magic, length = struct.unpack('>I', data[:4])[0], struct.unpack('<Q', data[4:12])[0]
    if got_magic != magic:
        raise ValueError(f'{what}: magic {got_magic:#010x}, expected {magic:#010x}')
    if length != len(data):
        raise ValueError(f'{what}: length {length} in its header, {len(data)} read')
    crc = struct.unpack('<I', data[-4:])[0]
    if native.crc32c(data[:-4]) != crc:
        raise ValueError(f'{what}: CRC-32C mismatch')
    r = _Reader(data[:-4], what)
    r.i = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f'{what}: format version {version}')
    body = data[r.i:-4]
    if compression == 0:
        return body
    if compression == 1:
        return native.zstd_decompress(body)
    raise ValueError(f'{what}: unknown compression {compression}')


def _data_file_table(r: _Reader, transitive: str) -> List[Tuple[str, str]]:
    """[(base path, relative path)] of a node's or manifest's data files."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    out, prev = [], b''
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f'{r.what}: bad data file path prefix')
        path = prev[:prefix[i]] + r.take(suffix[i])
        prev = path
        if base_len[i] > len(path):
            raise ValueError(f'{r.what}: bad data file base path')
        text = path.decode()
        out.append((transitive + text[:base_len[i]], text[base_len[i]:]))
    return out


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    subtree = r.varints(n) if interior else []
    keys, prev = [], b''
    for i in range(n):
        if prefix[i] > len(prev):
            raise ValueError(f'{r.what}: bad key prefix length')
        key = prev[:prefix[i]] + r.take(suffix[i])
        if i and key <= prev:
            raise ValueError(f'{r.what}: keys out of order')
        keys.append(key)
        prev = key
    return keys, subtree


def _file_ref(files: List[Tuple[str, str]], i: int, what: str) -> Tuple[str, str]:
    if i >= len(files):
        raise ValueError(f'{what}: data file {i} of {len(files)}')
    return files[i]


class OcdbtStore:
    """The newest version of the OCDBT store in ``root`` (a directory with a
    ``manifest.ocdbt``): ``list()`` its keys, ``read(key)`` a value."""

    def __init__(self, root: str):
        self.root = os.fspath(root)
        data = self._read_file('manifest.ocdbt', 0, None)
        r = _Reader(decode_envelope(data, MANIFEST_MAGIC, self._where('manifest.ocdbt')),
                    self._where('manifest.ocdbt'))
        r.take(16)  # uuid
        manifest_kind = r.varint()
        if manifest_kind != 0:
            raise ValueError(f'{r.what}: manifest kind {manifest_kind} (only single '
                             'manifests are read)')
        r.varint()  # max_inline_value_bytes
        r.varint()  # max_decoded_node_bytes
        r.byte()    # version_tree_arity_log2
        if r.varint() == 1:
            r.take(4)  # zstd level
        files = _data_file_table(r, '')
        n = r.varint()
        gen = r.varints(n)
        height = [r.byte() for _ in range(n)]
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        self._entries: Dict[bytes, _Value] = {}
        self.height = -1   # the root's height; -1 for an empty store
        if n == 0:
            return
        last = max(range(n), key=gen.__getitem__)  # the newest version
        if length[last] == 0:
            return  # an empty tree
        base, rel = _file_ref(files, fid[last], r.what)
        self.height = height[last]
        self._walk(base, rel, off[last], length[last], height[last], b'')

    def _where(self, rel: str) -> str:
        return os.path.join(self.root, rel)

    def _read_file(self, rel: str, offset: int, length) -> bytes:
        path = self._where(rel)
        with open(path, 'rb') as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise ValueError(f'{path}: {len(data)} bytes at {offset}, {length} expected')
        return data

    def _walk(self, base: str, rel: str, offset: int, length: int, height: int,
              prefix: bytes) -> None:
        where = f'{self._where(base + rel)}@{offset}'
        r = _Reader(decode_envelope(self._read_file(base + rel, offset, length), NODE_MAGIC,
                                    where), where)
        if r.byte() != height:
            raise ValueError(f'{where}: node height differs from its reference')
        files = _data_file_table(r, base)
        n = r.varint()
        if n == 0:
            raise ValueError(f'{where}: node without entries')
        keys, subtree = _keys(r, n, interior=height > 0)
        if height > 0:
            fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
            for i in range(n):
                child_base, child_rel = _file_ref(files, fid[i], where)
                self._walk(child_base, child_rel, off[i], ln[i], height - 1,
                           prefix + keys[i][:subtree[i]])
            return
        value_len = r.varints(n)
        kinds = [r.byte() for _ in range(n)]
        if any(k > 1 for k in kinds):
            raise ValueError(f'{where}: unknown value kind')
        indirect = [i for i in range(n) if kinds[i] == 1]
        fid = r.varints(len(indirect))
        off = r.varints(len(indirect))
        for i, f, o in zip(indirect, fid, off):
            vb, vr = _file_ref(files, f, where)
            self._entries[prefix + keys[i]] = (vb + vr, o, value_len[i])
        for i in range(n):
            if kinds[i] == 0:
                self._entries[prefix + keys[i]] = r.take(value_len[i])

    def list(self) -> List[str]:
        """Every key, sorted."""
        return sorted(k.decode() for k in self._entries)

    def read(self, key: str) -> bytes:
        """The value of ``key``; ``KeyError`` when absent."""
        value = self._entries[key.encode() if isinstance(key, str) else key]
        if isinstance(value, bytes):
            return value
        return self._read_file(*value)

    def __contains__(self, key: str) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._entries
