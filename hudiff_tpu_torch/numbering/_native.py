# Copied from hudiff_tpu/numbering/_native.py, on the port's own library.
"""ctypes bridge to the native NW aligner (hudiff_tpu_torch/csrc/aligner.cc).

The DP runs in f32 (the Python DP in f64), so a score can differ in its
last places and a tie between two paths may break the other way."""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ..native import load

# hd_align_batch marks an item that does not embed with kNegInf = -1e30
# (aligner.cc)
_FAILED = -5e29


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def align(q_idx: List[int], score_mat: np.ndarray, skip_cost: np.ndarray
          ) -> Tuple[Optional[List[int]], float]:
    """(the query index in each of the m columns, -1 where empty; score), or
    (None, -inf) when the query cannot be embedded."""
    lib = load()
    q = np.asarray(q_idx, dtype=np.int32)
    m = score_mat.shape[0]
    score32 = np.ascontiguousarray(score_mat, dtype=np.float32)
    skip32 = np.ascontiguousarray(skip_cost, dtype=np.float32)
    out_cols = np.empty(m, dtype=np.int32)
    out_score = np.empty(1, dtype=np.float32)
    rc = lib.hd_align(_ptr(q), len(q), _ptr(score32), _ptr(skip32), m, _ptr(out_cols),
                      _ptr(out_score))
    if rc != 0:
        return None, float('-inf')
    return out_cols.tolist(), float(out_score[0])


def align_batch(queries: List[List[int]], score_mat: np.ndarray, skip_cost: np.ndarray
                ) -> List[Tuple[Optional[List[int]], float]]:
    """``align`` over N queries in one call (``hd_align_batch``)."""
    lib = load()
    nb = len(queries)
    if nb == 0:
        return []
    m = score_mat.shape[0]
    max_n = max(len(q) for q in queries)
    q = np.full((nb, max_n), -2, dtype=np.int32)
    lens = np.empty(nb, dtype=np.int32)
    for i, qi in enumerate(queries):
        q[i, : len(qi)] = qi
        lens[i] = len(qi)
    score32 = np.ascontiguousarray(score_mat, dtype=np.float32)
    skip32 = np.ascontiguousarray(skip_cost, dtype=np.float32)
    out_cols = np.empty((nb, m), dtype=np.int32)
    out_scores = np.empty(nb, dtype=np.float32)
    lib.hd_align_batch(_ptr(q), _ptr(lens), nb, max_n, _ptr(score32), _ptr(skip32), m,
                       _ptr(out_cols), _ptr(out_scores))
    return [(None, float('-inf')) if out_scores[i] <= _FAILED
            else (out_cols[i].tolist(), float(out_scores[i])) for i in range(nb)]
