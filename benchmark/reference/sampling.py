"""The reference's reading of served humanization rows.

A humanization round fills a row's masked slots one forward each, in its
order: at step t the denoiser reads the grid with the first t slots of the
order filled and draws slot ``order[t]`` by Gumbel-max over the 22 tokens
of the sampling vocabulary (every token but <msk>), from
``u = torch.rand((B, 1, 22))`` of the round's generator, one draw a step,
``gumbel = -log(-log(max(u, tiny)))``. Given the noise, a draw is greedy on
the perturbed logits, so the reference can judge it:

- it rebuilds each step's grid from the row's input and its served tokens
  (teacher forcing: what the row held when that slot was drawn);
- runs its float32 model over those grids in blocks;
- and reads the gap by which the served token's perturbed logit lies below
  the best perturbed logit, the largest over all checked steps.

``control_gap`` reads the same gap for the token that a lower-precision
copy of the reference (``mm``) puts first at each step.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .denoiser import identity, no_tf32

VOCAB = 22


def gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def round_noise(seed: int, B: int, steps: int, device, skip: int = 0) -> torch.Tensor:
    """[steps, B, 22] uniforms of a round whose generator was seeded with
    ``seed``, after ``skip`` earlier steps drawn from it."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = []
    for i in range(skip + steps):
        u = torch.rand((B, 1, VOCAB), generator=g, device=device, dtype=torch.float32)
        if i >= skip:
            out.append(u[:, 0])
    return torch.stack(out)


def teacher_forced(x0: np.ndarray, order: np.ndarray, y: np.ndarray):
    """(grids [P, L], slots [P], served [P]) of one row: grid t is ``x0``
    with the first t slots of ``order`` (-1 slots skipped) set to ``y``."""
    slots = np.asarray([s for s in order if s >= 0], np.int64)
    grids = np.repeat(np.asarray(x0, np.int64)[None], len(slots), axis=0)
    for t in range(1, len(slots)):
        grids[t:, slots[t - 1]] = y[slots[t - 1]]
    return grids, slots, np.asarray(y, np.int64)[slots]


def widest_gap(logits_fn: Callable, params, cfg: dict, rows: Sequence[dict], device,
               block: int = 64, mm: Optional[Callable] = None) -> dict:
    """The widest gap over ``rows``, each a dict with ``x0``, ``order``,
    ``y`` (numpy [L], [W], [L]), ``region`` [L], ``chain`` ([2] or None) and
    ``u`` (torch [W, 22], the row's noise by step). With ``mm`` also the
    control's widest gap (the token ``mm``'s copy puts first, read under
    the float32 reference). Returns {'gap': ..., 'control_gap': ...,
    'tokens': n}."""
    grids, slots, served, noise, region, chain = [], [], [], [], [], []
    for r in rows:
        g, s, v = teacher_forced(r['x0'], r['order'], r['y'])
        grids.append(g)
        slots.append(s)
        served.append(v)
        noise.append(r['u'][:len(s)].to(device))
        region.append(np.repeat(np.asarray(r['region'])[None], len(s), axis=0))
        if r.get('chain') is not None:
            chain.append(np.repeat(np.asarray(r['chain'])[None], len(s), axis=0))
    grids = torch.as_tensor(np.concatenate(grids), device=device)
    slots = torch.as_tensor(np.concatenate(slots), device=device)
    served = torch.as_tensor(np.concatenate(served), device=device)
    noise = gumbel(torch.cat(noise))
    region = torch.as_tensor(np.concatenate(region), dtype=torch.long, device=device)
    chain = (torch.as_tensor(np.concatenate(chain), dtype=torch.long, device=device)
             if chain else None)
    gap, ctrl = [], []
    with torch.inference_mode(), no_tf32():
        for s in range(0, len(grids), block):
            e = min(len(grids), s + block)
            ix = torch.arange(e - s, device=device)
            c = None if chain is None else chain[s:e]
            ref = logits_fn(params, cfg, grids[s:e], region[s:e], c, identity)
            pert = ref[ix, slots[s:e], :VOCAB].float() + noise[s:e]
            best = pert.max(dim=-1).values
            gap.append(best - pert[ix, served[s:e]])
            if mm is not None:
                low = logits_fn(params, cfg, grids[s:e], region[s:e], c, mm)
                top = (low[ix, slots[s:e], :VOCAB].float() + noise[s:e]).argmax(dim=-1)
                ctrl.append(best - pert[ix, top])
    out = {'gap': float(torch.cat(gap).max()), 'tokens': int(len(grids))}
    if mm is not None:
        out['control_gap'] = float(torch.cat(ctrl).max())
    return out


def writeback_faults(x0: np.ndarray, order: np.ndarray, y: np.ndarray) -> int:
    """Slots a served row got wrong: every slot outside its order kept as
    given, every slot in its order drawn from the sampling vocabulary."""
    ordered = np.zeros(len(x0), bool)
    ordered[[s for s in order if s >= 0]] = True
    kept = int(np.count_nonzero(y[~ordered] != x0[~ordered]))
    drawn = y[ordered]
    return kept + int(np.count_nonzero((drawn < 0) | (drawn >= VOCAB)))


def start_faults(seq: str, clean: np.ndarray, x0: np.ndarray, positions: Sequence[int],
                 mask_table: np.ndarray, alphabet: List[str], pad: int, msk: int) -> int:
    """Faults of a row's start: its clean grid must hold exactly ``seq`` in
    order, and its masked slots must be the grid's occupied slots that the
    mask table frees (0), every other slot given clean."""
    faults = int(''.join(alphabet[int(i)] for i in clean if int(i) != pad) != seq)
    want = (mask_table == 0) & (clean != pad)
    got = np.zeros(len(x0), bool)
    got[list(positions)] = True
    faults += int(np.count_nonzero(want != got))
    faults += int(np.count_nonzero(x0[want] != msk))
    return faults + int(np.count_nonzero(x0[~want] != clean[~want]))


AHO_COLUMNS = 149


def filter_keeps(y: np.ndarray, pad: int, unknown: int) -> bool:
    """Whether the nanobody humanizer's validity filter keeps a candidate
    grid: HuDiff keeps the candidates that still number as heavy chains
    (``nanosample.py``), which on the AHo scheme takes residues that are
    standard or unknown (X) and at most 149 of them, one a column."""
    res = y[y != pad]
    return bool((res <= unknown).all() and len(res) <= AHO_COLUMNS)


def most_similar(clean: np.ndarray, grids: Sequence[np.ndarray], pad: int) -> int:
    """The first candidate of the highest identity to the parent's grid,
    over the slots occupied in either."""
    scores = []
    for g in grids:
        occ = (clean != pad) | (g != pad)
        scores.append(float(((clean == g) & occ).sum() / occ.sum()) if occ.any() else 0.0)
    return int(np.argmax(scores))


def filter_faults(clean: np.ndarray, result: dict, rows: int, alphabet: List[str], pad: int,
                  unknown: int) -> int:
    """Faults of one request's filtered result against the reference's
    rule: a sound round's candidates all pass it (every drawn token is of
    the sampling vocabulary, the rest of the grid the parent's), so the
    result holds all ``rows`` of them, each kept by ``filter_keeps``, each
    sequence its grid's residues, and ``best_idx`` the most similar."""
    grids = list(result['grids'])
    faults = max(0, rows - len(grids))
    faults += sum(not filter_keeps(g, pad, unknown) for g in grids)
    faults += sum(s != ''.join(alphabet[int(i)] for i in g if int(i) != pad)
                  for s, g in zip(result['seqs'], grids))
    return faults + int(bool(grids) and result['best_idx'] != most_similar(clean, grids, pad))
