"""The port's host C++ library: the AHo aligner and the record-store reader.

Counterpart of hudiff_tpu/native/__init__.py, built from the port's own
sources (``hudiff_tpu_torch/csrc/aligner.cc`` and ``recordstore.cc``)
instead of a committed library. ``load()`` compiles them on first use with
``$CXX`` (default ``c++``) into ``build/hudiff_tpu_torch/libhudiff_native-
<hash>.so`` beside the package (the hash is of both sources, the compiler,
the flags and the host's CPU, which ``-march=native`` builds for, so an
edited source or another machine rebuilds) and returns the ``ctypes``
library with every entry's signature declared. Nothing runs at import
time. A failed build raises ``RuntimeError`` with the compiler's output;
there is no fallback. ``ctypes`` releases the interpreter lock for the
length of each call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Dict

from ..ops._build import BUILD_DIR, CSRC_DIR

SOURCES = ('aligner.cc', 'recordstore.cc')
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
}


def compiler() -> str:
    return os.environ.get('CXX') or 'c++'


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
