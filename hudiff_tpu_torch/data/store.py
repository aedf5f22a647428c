# Copied from hudiff_tpu/data/store.py without the native reader.
"""RecordStore: memory-mapped append-only record storage.

Replaces the reference's LMDB training-data store
(dataset/oas_pair_dataset_new.py:185-259) with a two-file format,
``<name>.bin`` (the payload) and ``<name>.idx`` (``HDRS0001``, the record
count, then an (offset, length) pair per record), the JAX package's. Reads
go through Python's ``mmap``; the JAX package's native reader
(csrc/recordstore.cc) is not carried over.

Records are arbitrary bytes; ``put_obj``/``get_obj`` add pickle on top:
open only stores this program wrote.
"""
from __future__ import annotations

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
    """Read-only view over a RecordStoreWriter output, through mmap."""

    def __init__(self, path: str):
        self.path = path
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
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self._file.close()


def exists(path: str) -> bool:
    return os.path.exists(path + '.idx') and os.path.exists(path + '.bin')
