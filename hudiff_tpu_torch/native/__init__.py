"""The port's host C++ library (the AHo aligner, the record-store reader and
CRC-32C) and its binding of the host's zstd library.

Counterpart of hudiff_tpu/native/__init__.py, built from the port's own
sources (``hudiff_tpu_torch/csrc/aligner.cc``, ``recordstore.cc`` and
``crc32c.cc``) instead of a committed library. ``load()`` compiles them on first use with
``$CXX`` (default ``c++``) into ``build/hudiff_tpu_torch/libhudiff_native-
<hash>.so`` beside the package (the hash is of the sources, the compiler,
the flags and the host's CPU, which ``-march=native`` builds for, so an
edited source or another machine rebuilds) and returns the ``ctypes``
library with every entry's signature declared. Nothing runs at import
time. A failed build raises ``RuntimeError`` with the compiler's output;
there is no fallback. ``ctypes`` releases the interpreter lock for the
length of each call.

``zstd_decompress`` and ``crc32c`` serve the reader of the JAX package's
Orbax checkpoints (``training/ocdbt.py``). ``zstd_decompress`` calls the
host's zstd library (``libzstd.so.1``, the reference decoder, which Linux
distributions install with their package manager) through its stable
streaming API, declared here by hand, so neither its header nor a Python
zstd package is needed.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Dict, Optional

from ..ops._build import BUILD_DIR, CSRC_DIR

SOURCES = ('aligner.cc', 'recordstore.cc', 'crc32c.cc')
CXX_FLAGS = ('-O3', '-march=native', '-fPIC', '-std=c++17', '-shared')

_LIBS: Dict[Path, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_SIGNATURES = {
    # name: (restype, argtypes)
    'hd_align': (ctypes.c_int, [_P, ctypes.c_int32, _P, _P, ctypes.c_int32, _P, _P]),
    'hd_align_batch': (ctypes.c_int, [_P, _P, ctypes.c_int32, ctypes.c_int32, _P, _P,
                                      ctypes.c_int32, _P, _P]),
    'hd_rs_open': (_P, [ctypes.c_char_p]),
    'hd_rs_len': (ctypes.c_int64, [_P]),
    'hd_rs_record_len': (ctypes.c_int64, [_P, ctypes.c_int64]),
    'hd_rs_get': (ctypes.c_int, [_P, ctypes.c_int64, _P]),
    'hd_rs_gather': (ctypes.c_int64, [_P, _P, ctypes.c_int32, _P, ctypes.c_int64, _P]),
    'hd_rs_close': (None, [_P]),
    'hd_crc32c': (ctypes.c_uint32, [ctypes.c_char_p, ctypes.c_size_t]),
}


def compiler() -> str:
    return os.environ.get('CXX') or 'c++'


@functools.lru_cache(maxsize=None)
def _host_cpu() -> str:
    """The machine, and the first CPU's model and feature flags
    (``-march=native`` builds for them)."""
    seen = {}
    try:
        with open('/proc/cpuinfo') as f:
            for line in f:
                key = line.split(':', 1)[0].strip()
                if key in ('model name', 'flags') and key not in seen:
                    seen[key] = line.strip()
    except OSError:
        pass
    return ' '.join([platform.machine(), *seen.values()])


def library_path() -> Path:
    digest = hashlib.sha1()
    for name in SOURCES:
        digest.update((CSRC_DIR / name).read_bytes())
    digest.update(' '.join((compiler(), *CXX_FLAGS, _host_cpu())).encode())
    return BUILD_DIR / f'libhudiff_native-{digest.hexdigest()[:12]}.so'


def build() -> Path:
    """Compile the library unless it is built; returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [compiler(), *CXX_FLAGS, '-o', str(tmp), *(str(CSRC_DIR / n) for n in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'cannot run the C++ compiler {compiler()!r} ({e}); '
                           'set CXX to one') from e
    if proc.returncode != 0:
        raise RuntimeError(f'building {path.name} failed (exit {proc.returncode}): '
                           f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)  # atomic: concurrent builds agree
    return path


def load() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    path = library_path()
    lib = _LIBS.get(path)
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _LIBS[path] = lib
    return lib


class _ZstdBuffer(ctypes.Structure):
    """``ZSTD_inBuffer`` / ``ZSTD_outBuffer`` (zstd.h): a pointer, its size
    and the position reached."""
    _fields_ = [('ptr', _P), ('size', ctypes.c_size_t), ('pos', ctypes.c_size_t)]


_ZSTD_SIGNATURES = {
    'ZSTD_versionNumber': (ctypes.c_uint, []),
    'ZSTD_createDCtx': (_P, []),
    'ZSTD_freeDCtx': (ctypes.c_size_t, [_P]),
    'ZSTD_decompressStream': (ctypes.c_size_t, [_P, ctypes.POINTER(_ZstdBuffer),
                                                ctypes.POINTER(_ZstdBuffer)]),
    'ZSTD_isError': (ctypes.c_uint, [ctypes.c_size_t]),
    'ZSTD_getErrorName': (ctypes.c_char_p, [ctypes.c_size_t]),
}


@functools.lru_cache(maxsize=None)
def libzstd() -> ctypes.CDLL:
    """The host's zstd library with the entries used here declared."""
    names = ['libzstd.so.1', ctypes.util.find_library('zstd')]
    for name in filter(None, names):
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise RuntimeError('the zstd library (libzstd.so.1) is not installed; reading Orbax '
                           'checkpoints needs it (the libzstd1 package or its equivalent)')
    for name, (restype, argtypes) in _ZSTD_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def zstd_version() -> str:
    """The host zstd library's version, e.g. ``'1.5.5'``."""
    v = libzstd().ZSTD_versionNumber()
    return f'{v // 10000}.{v // 100 % 100}.{v % 100}'


def zstd_decompress(data: bytes, size_hint: Optional[int] = None) -> bytes:
    """The content of every zstd frame in ``data`` (skippable frames give
    nothing). ``size_hint``, the size expected, sizes the output buffer.
    Raises ``ValueError`` on empty input, a truncated or corrupted frame, a
    frame that needs a dictionary or a content checksum that does not match;
    it never returns part of the content."""
    lib = libzstd()
    data = bytes(data)
    if not data:
        raise ValueError('zstd: empty input')
    cap = max(size_hint or 0, 1 << 17)
    buf = ctypes.create_string_buffer(cap)
    src = _ZstdBuffer(ctypes.cast(ctypes.c_char_p(data), _P), len(data), 0)
    parts = []
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError('zstd: cannot allocate a decompression context')
    try:
        while True:
            dst = _ZstdBuffer(ctypes.addressof(buf), cap, 0)
            ret = lib.ZSTD_decompressStream(dctx, ctypes.byref(dst), ctypes.byref(src))
            if lib.ZSTD_isError(ret):
                raise ValueError(f'zstd: {lib.ZSTD_getErrorName(ret).decode()}')
            parts.append(ctypes.string_at(buf, dst.pos))
            if src.pos == src.size:
                if ret == 0:   # the last frame is decoded and flushed
                    return b''.join(parts)
                if dst.pos < cap:   # no input left and nothing more to flush
                    raise ValueError('zstd: truncated frame')
    finally:
        lib.ZSTD_freeDCtx(dctx)


def crc32c(data: bytes) -> int:
    """The CRC-32C (Castagnoli) of ``data``."""
    data = bytes(data)
    return int(load().hd_crc32c(data, len(data)))
