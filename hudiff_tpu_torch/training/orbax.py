"""The JAX package's Orbax checkpoints, read with numpy and the port's own
OCDBT reader (``training/ocdbt.py``, over the host's libzstd): no JAX,
orbax, tensorstore or Python zstd package.

A run directory holds ``step_<n>/`` (the Orbax checkpoint), ``step_<n>.json``
(the step's metadata) and ``LATEST``, as hudiff_tpu/training/checkpoints.py
writes them. In ``step_<n>/``:

- ``_METADATA`` is JSON: ``tree_metadata`` maps each leaf to its
  ``key_metadata`` (the path, each key a dict key or a sequence index) and its
  ``value_metadata`` (``np.ndarray`` leaves are arrays; ``None`` and empty
  ``Dict`` leaves carry no data). ``use_ocdbt`` must be true and
  ``use_zarr3`` false.
- ``manifest.ocdbt`` is the OCDBT store holding one zarr v2 array per leaf:
  ``<k1>.<k2>...<kn>/.zarray`` (its JSON header) and chunk keys such as
  ``<name>/0.0``, each chunk C-ordered and zstd-compressed or raw.

``restore_orbax`` returns what the JAX package's ``restore`` returns:
``{'payload', 'meta', 'step'}``, with numpy leaves, sequences as lists and
dicts as dicts. bfloat16 leaves are widened to float32 through their bit
pattern (numpy has no bfloat16).

The ``.qkv_layout`` marker beside the steps says how the merged qkv columns
are laid out. JAX's own ``save`` writes none, and every checkpoint it has
written since the head-major layout is head-major, so a missing marker reads
as head-major; ``head-major`` reads as is; any other content raises, naming
``python -m hudiff_tpu_torch.tools.migrate_qkv_layout``.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import math
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .. import native
from .ocdbt import OcdbtStore

KEY_SEQUENCE, KEY_DICT = 1, 2
_EMPTY = {'None': lambda: None, 'Dict': dict}   # leaves Orbax stores no data for
LAYOUT_MARKER = '.qkv_layout'
HEAD_MAJOR = 'head-major'


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f'step_{step}')


def is_orbax_step(path: str) -> bool:
    """True for an Orbax OCDBT checkpoint directory (``step_<n>/``)."""
    return os.path.isfile(os.path.join(path, 'manifest.ocdbt'))


def orbax_steps(ckpt_dir: str) -> List[int]:
    """The steps of a run directory that are Orbax checkpoints."""
    steps = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            if name.startswith('step_') and name[5:].isdigit() and \
                    is_orbax_step(os.path.join(ckpt_dir, name)):
                steps.append(int(name[5:]))
    return sorted(steps)


def is_orbax_run(ckpt_dir: str) -> bool:
    """True when ``ckpt_dir`` holds at least one Orbax step."""
    return bool(orbax_steps(ckpt_dir))


def qkv_layout(ckpt_dir: str) -> Optional[str]:
    """The ``.qkv_layout`` marker's content, or None when there is none."""
    path = os.path.join(ckpt_dir, LAYOUT_MARKER)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip()


def check_layout(ckpt_dir: str) -> None:
    layout = qkv_layout(ckpt_dir)
    if layout not in (None, HEAD_MAJOR):
        raise ValueError(
            f'{ckpt_dir}: .qkv_layout says {layout!r}; the port reads head-major '
            'qkv columns. Convert it with `python -m hudiff_tpu_torch.tools.'
            'migrate_qkv_layout <ckpt_dir> <out_dir>`')


# ---------------------------------------------------------------------------
# zarr v2 arrays
# ---------------------------------------------------------------------------

def _dtype(text: str) -> Tuple[np.dtype, bool]:
    """(numpy dtype of the stored bytes, whether they are bfloat16)."""
    if text == 'bfloat16':
        return np.dtype('<u2'), True
    dt = np.dtype(text)
    if dt.kind not in 'fiub':
        raise ValueError(f'unsupported zarr dtype {text!r}')
    return dt, False


def _fill(value, dtype: np.dtype):
    if value is None:
        return 0
    if isinstance(value, str):
        return {'NaN': np.nan, 'Infinity': np.inf, '-Infinity': -np.inf}[value]
    return value


def _chunk(raw: bytes, compressor, dtype: np.dtype, shape, name: str) -> np.ndarray:
    want = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    if compressor is not None:
        if compressor.get('id') != 'zstd':
            raise ValueError(f'{name}: unsupported zarr compressor {compressor!r}')
        raw = native.zstd_decompress(raw, size_hint=want)
    if len(raw) != want:
        raise ValueError(f'{name}: chunk of {len(raw)} bytes, {want} expected')
    return np.frombuffer(raw, dtype=dtype).reshape(shape)


def read_array(store: OcdbtStore, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``, assembled from its chunks (an
    absent chunk takes the fill value)."""
    meta = json.loads(store.read(f'{name}/.zarray'))
    if meta.get('zarr_format') != 2:
        raise ValueError(f'{name}: zarr format {meta.get("zarr_format")}')
    if meta.get('order', 'C') != 'C' or meta.get('filters'):
        raise ValueError(f'{name}: only C-ordered arrays without filters are read')
    dtype, bf16 = _dtype(meta['dtype'])
    shape, chunks = list(meta['shape']), list(meta['chunks'])
    sep = meta.get('dimension_separator', '.')
    out = np.empty(shape, dtype=dtype)
    fill = _fill(meta.get('fill_value'), dtype)
    if bf16 and fill != 0:
        fill = int(np.array(fill, np.float32).view(np.uint32) >> 16)
    if not shape:
        key = f'{name}/0'
        out[...] = (_chunk(store.read(key), meta.get('compressor'), dtype, (), name)
                    if key in store else fill)
    else:
        grid = [range(math.ceil(s / c)) if s else range(0) for s, c in zip(shape, chunks)]
        for idx in itertools.product(*grid):
            key = f'{name}/' + sep.join(str(i) for i in idx)
            sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
            if key not in store:
                out[sl] = fill
                continue
            part = _chunk(store.read(key), meta.get('compressor'), dtype, chunks, key)
            out[sl] = part[tuple(slice(0, s.stop - s.start) for s in sl)]
    if bf16:
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


# ---------------------------------------------------------------------------
# The tree
# ---------------------------------------------------------------------------

def _build(entries: List[Tuple[List[dict], Any]]):
    """Nest (key_metadata, leaf) pairs: sequence keys make lists, dict keys
    dicts."""
    if len(entries) == 1 and not entries[0][0]:
        return entries[0][1]
    kinds = {keys[0]['key_type'] for keys, _ in entries}
    if len(kinds) != 1:
        raise ValueError('a node mixes sequence and dict keys')
    groups: Dict[Any, list] = {}
    for keys, leaf in entries:
        groups.setdefault(keys[0]['key'], []).append((keys[1:], leaf))
    if kinds == {KEY_SEQUENCE}:
        idx = sorted(groups, key=int)
        if [int(i) for i in idx] != list(range(len(idx))):
            raise ValueError('a sequence with missing indices')
        return [_build(groups[i]) for i in idx]
    if kinds != {KEY_DICT}:
        raise ValueError(f'unknown key type {kinds}')
    return {k: _build(v) for k, v in groups.items()}


def read_step(path: str) -> Dict[str, Any]:
    """The tree of the Orbax checkpoint ``path`` (a ``step_<n>/``)."""
    with open(os.path.join(path, '_METADATA')) as f:
        meta = json.load(f)
    if not meta.get('use_ocdbt', False) or meta.get('use_zarr3', False):
        raise ValueError(f'{path}: only OCDBT checkpoints of zarr v2 arrays are read '
                         f"(use_ocdbt={meta.get('use_ocdbt')}, "
                         f"use_zarr3={meta.get('use_zarr3')})")
    store = OcdbtStore(path)
    entries = []
    for item in meta['tree_metadata'].values():
        keys = item['key_metadata']
        vtype = item['value_metadata']['value_type']
        if vtype == 'np.ndarray':
            leaf = read_array(store, '.'.join(str(k['key']) for k in keys))
        elif vtype in _EMPTY:
            leaf = _EMPTY[vtype]()
        else:
            raise ValueError(f'{path}: unsupported leaf type {vtype!r}')
        entries.append((keys, leaf))
    if not entries:
        return {}
    return _build(entries)


def restore_orbax(ckpt_dir: str, step: Optional[int] = None,
                  layout_check: bool = True) -> Dict[str, Any]:
    """``{'payload', 'meta', 'step'}`` of a JAX run directory, as
    hudiff_tpu/training/checkpoints.py::restore gives them (numpy leaves).
    ``layout_check=False`` skips the ``.qkv_layout`` check (the migrate tool
    reads part-major directories)."""
    if layout_check:
        check_layout(ckpt_dir)
    if step is None:
        from .checkpoints import latest_step   # the one default-step rule of both formats
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {ckpt_dir}')
    payload = read_step(step_dir(ckpt_dir, step))
    meta_path = os.path.join(ckpt_dir, f'step_{step}.json')
    meta = {'step': step}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return {'payload': payload, 'meta': meta, 'step': step}


def iter_leaves(tree, prefix: str = '') -> Iterator[Tuple[str, Any]]:
    """(path, leaf) of every leaf in key order: dict keys sorted, sequences
    by index; ``None`` and empty containers give nothing."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], f'{prefix}/{k}')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from iter_leaves(v, f'{prefix}/{i}')
    elif tree is not None:
        yield prefix, tree


def leaves_digest(tree) -> Tuple[str, int, int]:
    """(SHA-256 hex, leaf count, bytes) over every leaf in key order: each
    leaf's path, dtype, shape and C-ordered bytes."""
    h = hashlib.sha256()
    n = nbytes = 0
    for path, leaf in iter_leaves(tree):
        a = np.ascontiguousarray(np.asarray(leaf))
        h.update(f'{path}|{a.dtype.str}|{a.shape}|'.encode())
        h.update(a.tobytes())
        n += 1
        nbytes += a.nbytes
    return h.hexdigest(), n, nbytes
