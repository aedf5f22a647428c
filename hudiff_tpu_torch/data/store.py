# Copied from hudiff_tpu/data/store.py; the native reader is the port's own build.
"""RecordStore: memory-mapped append-only record storage.

Replaces the reference's LMDB training-data store
(dataset/oas_pair_dataset_new.py:185-259) with a two-file format,
``<name>.bin`` (the payload) and ``<name>.idx`` (``HDRS0001``, the record
count, then an (offset, length) pair per record), the JAX package's. Reads
go through the port's C++ reader (hudiff_tpu_torch/csrc/recordstore.cc,
built on first use; its calls release the interpreter lock), or through
Python's ``mmap`` with ``native=False``; both read the same records.

Records are arbitrary bytes; ``put_obj``/``get_obj`` add pickle on top:
open only stores this program wrote.
"""
from __future__ import annotations

import ctypes
import mmap
import os
import pickle
import struct
from typing import Any, Iterator

_MAGIC = b'HDRS0001'
_IDX_ENTRY = struct.Struct('<QQ')  # offset, length


class RecordStoreWriter:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)) or '.', exist_ok=True)
        self._bin = open(path + '.bin', 'wb')
        self._offsets = []
        self._pos = 0

    def put(self, data: bytes) -> int:
        self._offsets.append((self._pos, len(data)))
        self._bin.write(data)
        self._pos += len(data)
        return len(self._offsets) - 1

    def put_obj(self, obj: Any) -> int:
        return self.put(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))

    def close(self) -> None:
        self._bin.close()
        with open(self.path + '.idx', 'wb') as f:
            f.write(_MAGIC)
            f.write(struct.pack('<Q', len(self._offsets)))
            for off, ln in self._offsets:
                f.write(_IDX_ENTRY.pack(off, ln))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordStore:
    """Read-only view over a RecordStoreWriter output, through the native
    reader, or through mmap when ``native`` is False."""

    def __init__(self, path: str, native: bool = True):
        self.path = path
        self._native = None
        if native:
            from ..native import load
            lib = load()
            handle = lib.hd_rs_open(path.encode())
            if not handle:
                raise ValueError(f'not a RecordStore (index or payload unreadable): {path}')
            self._native = (lib, ctypes.c_void_p(handle))
            self._n = int(lib.hd_rs_len(self._native[1]))
            return
        with open(path + '.idx', 'rb') as f:
            if f.read(8) != _MAGIC:
                raise ValueError(f'not a RecordStore index: {path}.idx')
            (self._n,) = struct.unpack('<Q', f.read(8))
            raw = f.read(self._n * _IDX_ENTRY.size)
        self._entries = [_IDX_ENTRY.unpack_from(raw, i * _IDX_ENTRY.size)
                         for i in range(self._n)]
        self._file = open(path + '.bin', 'rb')
        size = os.path.getsize(path + '.bin')
        self._mm = mmap.mmap(self._file.fileno(), size, access=mmap.ACCESS_READ) \
            if size else None

    def __len__(self) -> int:
        return self._n

    def get(self, idx: int) -> bytes:
        if self._native is not None:
            lib, handle = self._native
            ln = int(lib.hd_rs_record_len(handle, idx))
            if ln < 0:
                raise IndexError(idx)
            buf = ctypes.create_string_buffer(ln)
            if lib.hd_rs_get(handle, idx, buf) != 0:
                raise IndexError(idx)
            return buf.raw
        off, ln = self._entries[idx]
        return self._mm[off:off + ln]

    def get_obj(self, idx: int) -> Any:
        return pickle.loads(self.get(idx))

    def __getitem__(self, idx: int) -> Any:
        return self.get_obj(idx)

    def __iter__(self) -> Iterator[Any]:
        for i in range(self._n):
            yield self.get_obj(i)

    def close(self) -> None:
        if self._native is not None:
            lib, handle = self._native
            lib.hd_rs_close(handle)
            self._native = None
            return
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self._file.close()


def exists(path: str) -> bool:
    return os.path.exists(path + '.idx') and os.path.exists(path + '.bin')
