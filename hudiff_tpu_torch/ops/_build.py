"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``hudiff_tpu_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on first use into ``build/hudiff_tpu_torch/lib<name>-<hash>.so``
beside the package (the hash is of the source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source or header rebuilds).
Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits for
them; ``load(name)`` builds one source if needed and returns the library.
nvcc's output is kept beside each library (``lib<name>-<hash>.log``), so
that a later process reads ptxas's report of a library it did not build.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR.parent / 'build' / 'hudiff_tpu_torch'
SOURCES = ('rope_attention', 'rope_attention_bwd', 'bytenet_block', 'bytenet_block_bwd',
           'fused_layer')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_LOADED: Dict[str, ctypes.CDLL] = {}
# nvcc's output for each source built or loaded through build_all, read back
# from the log beside the library where an earlier process built it:
# ptxas's registers, shared memory, spills and warnings per kernel (-Xptxas -v)
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else
    ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
        return os.path.join(home, 'bin', 'nvcc')
    return shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC_DIR / f'{name}.cu').read_bytes())
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        digest.update(header.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:12]}.so'


def log_path(name: str) -> Path:
    """Where nvcc's output for the library ``library_path(name)`` is kept."""
    return library_path(name).with_suffix('.log')


def _start(name: str) -> Optional[Tuple[subprocess.Popen, Path]]:
    """Start nvcc for one source into a temporary file; None if built (its
    kept log, where there is one, goes into BUILD_LOGS)."""
    if library_path(name).exists():
        if log_path(name).exists():
            BUILD_LOGS[name] = log_path(name).read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = library_path(name).with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source in parallel; returns seconds per source
    (0.0 where the library was already built)."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    took, failed = {}, []
    for n, job in started.items():  # wait for every nvcc, even after a failure
        took[n] = 0.0
        if job is None:
            continue
        proc, tmp = job
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f'nvcc failed for {n}.cu (exit {proc.returncode}):\n{log}')
            continue
        kept = tmp.with_suffix('.log')
        kept.write_text(log)
        os.replace(kept, log_path(n))      # the log first: a library implies its log
        os.replace(tmp, library_path(n))  # atomic: concurrent builders agree
        took[n] = time.perf_counter() - t0
    if failed:
        raise RuntimeError('\n'.join(failed))
    return took


def load(name: str, signatures: Dict[str, list],
         restypes: Optional[Dict[str, type]] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C entry to its ctypes argtypes; an entry
    returns an int (a ``cudaError_t`` code) unless ``restypes`` names its
    return type."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = (restypes or {}).get(fn, ctypes.c_int)
        _LOADED[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a C entry returned a nonzero ``cudaError_t``."""
    if code != 0:
        raise RuntimeError(f'{what}: CUDA error {code} at launch')
