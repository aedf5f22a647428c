"""IMGT <-> AHo numbering-scheme transfer, static-shaped, on the tensors'
device.

Counterpart of hudiff_tpu/ops/scheme_transfer.py. The fine-tune frameworks
scatter infilled IMGT-grid residues into the AHo-aligned one-hot grids that
AbNatiV reads. Within each sample the k-th valid (non-pad) IMGT candidate
slot feeds the k-th valid (non-gap) AHo candidate slot: cumulative sums
and one scatter, no data-dependent shapes. Tail slots the reference leaves
out (IMGT heavy 150-151 / pair light 290; AHo heavy 147-148 / pair light
296) are not candidates.

Validity thresholds are the reference's: the nanobody path counts tokens
< 20 as residues (X excluded), the pair path tokens < 21 (X included).

On rows whose candidate counts match (``counts_match``, the reference's
runtime assert) the map is the JAX package's. On a row with more valid AHo
slots than IMGT ones, the AHo slots past the last IMGT residue keep their
original one-hot (source -1). The JAX map does so too, except on AHo
ranks at or past the IMGT candidate count (288 on the pair grid; the nano
grid has fewer AHo candidates): those it reads from the slot every
invalid candidate was scattered into, whose value depends on scatter
order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import constants as C

# Candidate slot index vectors (static).
NANO_IMGT_CAND = np.arange(150)                      # heavy grid minus tail
NANO_AHO_CAND = np.arange(147)                       # AHo heavy minus tail
PAIR_IMGT_CAND = np.concatenate([np.arange(150), np.arange(152, 290)])
PAIR_AHO_CAND = np.concatenate([np.arange(147), np.arange(149, 296), [297]])


class TransferMap(NamedTuple):
    src: torch.Tensor         # [B, L_aho] IMGT source slot per AHo slot, -1 = keep
    imgt_valid: torch.Tensor  # [B, n_imgt_cand] bool
    aho_valid: torch.Tensor   # [B, n_aho_cand] bool


def build_transfer_map(imgt_tokens: torch.Tensor, aho_onehot: torch.Tensor,
                       imgt_cand: np.ndarray, aho_cand: np.ndarray,
                       imgt_valid_max: int) -> TransferMap:
    """For every AHo grid slot, the IMGT slot that feeds it (-1: none).

    imgt_tokens: [B, L_imgt] token ids; valid slots are tokens < imgt_valid_max.
    aho_onehot: [B, L_aho, 21]; valid slots are argmax != gap (20).
    """
    B, L_aho = aho_onehot.shape[:2]
    dev = imgt_tokens.device
    icand = torch.as_tensor(imgt_cand, dtype=torch.long, device=dev)
    acand = torch.as_tensor(aho_cand, dtype=torch.long, device=dev)
    M = icand.shape[0]

    imgt_valid = imgt_tokens[:, icand] < imgt_valid_max                   # [B, M]
    aho_valid = (torch.argmax(aho_onehot, dim=-1) != C.ABNATIV_GAP_IDX)[:, acand]
    rank_imgt = torch.cumsum(imgt_valid.long(), dim=-1) - 1               # [B, M]
    rank_aho = torch.cumsum(aho_valid.long(), dim=-1) - 1                 # [B, N]

    # pos_of_rank[b, r] = IMGT slot of the r-th valid candidate; every
    # invalid candidate writes -1 into slot M, so no write depends on order
    dump = torch.where(imgt_valid, rank_imgt, M)
    vals = torch.where(imgt_valid, icand.expand(B, M), -1)
    pos_of_rank = torch.full((B, M + 1), -1, dtype=torch.long, device=dev).scatter_(
        1, dump, vals)
    src_cand = torch.where(aho_valid, torch.gather(pos_of_rank, 1, rank_aho.clamp(0, M)), -1)
    src = torch.full((B, L_aho), -1, dtype=torch.long, device=dev)
    src[:, acand] = src_cand
    return TransferMap(src=src, imgt_valid=imgt_valid, aho_valid=aho_valid)


def apply_transfer(imgt_onehot: torch.Tensor, aho_onehot: torch.Tensor,
                   tmap: TransferMap) -> torch.Tensor:
    """Gather IMGT one-hot rows into the AHo grid; keep the original where
    src = -1. Gradients reach ``imgt_onehot`` through the gather."""
    V = aho_onehot.shape[-1]
    safe_src = tmap.src.clamp(min=0)
    gathered = torch.gather(imgt_onehot, 1, safe_src[:, :, None].expand(-1, -1, V))
    return torch.where((tmap.src < 0)[:, :, None], aho_onehot, gathered.to(aho_onehot.dtype))


def transfer_mask(imgt_mask: torch.Tensor, tmap: TransferMap) -> torch.Tensor:
    """Project a boolean IMGT-slot mask through the map onto the AHo grid."""
    moved = torch.gather(imgt_mask, 1, tmap.src.clamp(min=0))
    return (tmap.src >= 0) & moved


def one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row
    (``torch.nn.functional.one_hot`` raises on one)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def imgt_grid_onehot(tokens: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Token grid -> AbNatiV-alphabet one-hot: the grid pad (21) maps to the
    gap channel (20); <msk> (22) one-hots to zeros (never present at
    transfer time). Reference trans_*_scheme pad remap
    (nanoencoder/model.py:547-550)."""
    remapped = torch.where(tokens == C.IDX_PAD, C.ABNATIV_GAP_IDX, tokens)
    return one_hot(remapped, C.ABNATIV_ALPHABET_SIZE, dtype)


def counts_match(imgt_tokens: torch.Tensor, aho_onehot: torch.Tensor, pair: bool
                 ) -> torch.Tensor:
    """Per-sample candidate-count equality (the reference's runtime
    asserts, for host-side data validation)."""
    if pair:
        icand, acand, vmax = PAIR_IMGT_CAND, PAIR_AHO_CAND, C.IDX_PAD
    else:
        icand, acand, vmax = NANO_IMGT_CAND, NANO_AHO_CAND, C.IDX_X
    tm = build_transfer_map(imgt_tokens, aho_onehot, icand, acand, vmax)
    return tm.imgt_valid.sum(-1) == tm.aho_valid.sum(-1)


def gumbel_straight_through(logits: torch.Tensor, temperature: float = 1.0,
                            generator: Optional[torch.Generator] = None,
                            u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hard one-hot forward, softmax gradient backward (reference
    gumbel_softmax, model/encoder/model.py:706-719). ``u`` are the uniform
    draws (``logits``' shape); without them they come from ``generator``.
    Ties in the hard choice go to the first index."""
    if u is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
    g = -torch.log(-torch.log(u + 1e-20) + 1e-20)
    probs = torch.softmax((logits + g) / temperature, dim=-1)
    hard = one_hot(torch.argmax(probs, dim=-1), logits.shape[-1], probs.dtype)
    return (hard - probs).detach() + probs
