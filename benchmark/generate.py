"""Traffic from the seed: framework mutants of parent antibodies, synthetic
training grids, OA-ARDM corruption masks, and the frozen IMGT tables.

Every function takes its randomness from an explicit generator seeded by
the caller, so that one seed gives the same inputs.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

DATA = Path(__file__).resolve().parent / 'data'
AMINO = 'ACDEFGHIKLMNPQRSTVWY'


def load_data(name: str) -> dict:
    with open(DATA / f'{name}.json') as f:
        return json.load(f)


def imgt() -> dict:
    """The frozen IMGT grid tables (``data/imgt.json``) as numpy arrays."""
    t = load_data('imgt')
    return {k: (np.asarray(v, np.int64) if isinstance(v, list) and k != 'tokens' else v)
            for k, v in t.items()}


def framework_mutant(seq: str, cdrs: Sequence[str], n: int, rng: np.random.Generator) -> str:
    """``seq`` with ``n`` residues outside its CDRs (the first occurrence of
    each) replaced by another amino acid."""
    kept = np.zeros(len(seq), bool)
    for cdr in cdrs:
        at = seq.index(cdr)
        kept[at:at + len(cdr)] = True
    sites = rng.choice(np.nonzero(~kept)[0], size=n, replace=False)
    out = list(seq)
    for s in sites:
        out[s] = rng.choice([a for a in AMINO if a != seq[s]])
    return ''.join(out)


def seed_sequence(seed: int, *keys: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63), *keys])


def pair_grids(n: int, heavy_len: int, light_len: int, pad_share: float,
               rng: np.random.Generator) -> np.ndarray:
    """[n, heavy_len + light_len] int32 grids of random amino acids with a
    share of slots empty (the pad token), distinct rows."""
    t = imgt()
    L = heavy_len + light_len
    grids = rng.integers(0, t['n_aa'], (n, L)).astype(np.int32)
    grids[rng.random((n, L)) < pad_share] = t['idx_pad']
    if len({g.tobytes() for g in grids}) != n:
        raise ValueError('pair_grids drew two equal rows')
    return grids


def oardm_masks(n: int, B: int, L: int, protected: np.ndarray, rng: np.random.Generator,
                window: int = None) -> np.ndarray:
    """[n, B, L] bool OA-ARDM corruption masks over the first ``window``
    slots (default all L): per row t ~ U{1, window-1}, ``window - t + 1``
    of those slots drawn uniformly without replacement, then the
    ``protected`` [L] slots cleared."""
    D = L if window is None else window
    counts = D - rng.integers(1, D, (n, B)) + 1
    scores = rng.random((n, B, L))
    scores[..., D:] = 2.0
    ranks = np.argsort(np.argsort(scores, axis=-1), axis=-1)
    return (ranks < counts[..., None]) & ~protected[None, None, :]


def bucket_width(k: int, cap: int) -> int:
    """The humanize CLI's order width for a run whose largest masked count
    is ``k`` and whose mode allows ``cap``: ``k`` rounded up to a multiple
    of 32, at most ``cap``."""
    if k >= cap:
        return cap
    return min(cap, ((max(k, 1) + 31) // 32) * 32)


def nano_finetune_rows(n: int, n_imgt: int, n_aho: int,
                       n_res: Tuple[int, int], idx_pad: int, gap: int,
                       rng: np.random.Generator):
    """(tokens [n, n_imgt + 2] int32, AHo indices [n, n_aho + 2] int32) of
    synthetic nanobodies: ``n_res`` random residues (a count drawn in
    [lo, hi)) placed in order on random slots of the first ``n_imgt`` IMGT
    slots and of the first ``n_aho`` AHo slots, the same residues in both;
    the last two slots of each grid (the tails) carry two more residues."""
    counts = rng.integers(n_res[0], n_res[1], n)
    res = rng.integers(0, 20, (n, n_imgt)).astype(np.int32)

    def place(slots):
        ranks = np.argsort(np.argsort(rng.random((n, slots)), axis=-1), axis=-1)
        chosen = ranks < counts[:, None]
        order = np.cumsum(chosen, axis=-1) - 1
        return np.where(chosen, np.take_along_axis(res, np.maximum(order, 0), axis=-1), -1)

    tail = rng.integers(0, 20, (n, 2)).astype(np.int32)
    imgt = place(n_imgt)
    tokens = np.concatenate([np.where(imgt < 0, idx_pad, imgt), tail], axis=1).astype(np.int32)
    aho = place(n_aho)
    aho = np.concatenate([np.where(aho < 0, gap, aho), tail], axis=1).astype(np.int32)
    return tokens, aho
