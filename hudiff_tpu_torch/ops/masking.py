"""OA-ARDM forward corruption, on the tensors' device.

Counterpart of hudiff_tpu/ops/masking.py:28-84. Semantics (the reference's):
- ``D`` is the padded grid length (291 pair / 152 heavy / 150 camel window);
- ``t ~ U{1, D-1}``, ``num_mask = D - t + 1`` positions are drawn uniformly
  without replacement;
- protected positions (CDRs; plus grid pads in mouse/camel modes) are then
  cleared from the mask, so realized mask counts shrink accordingly;
- masked positions are replaced by the <msk> token.

Draws come from an explicit ``torch.Generator`` on the tensors' device. Its
numbers are not JAX's; ``mask_from_scores`` is the rank step alone, so a
test can feed it the uniform scores ``jax.random.uniform`` drew and compare
masks exactly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import constants as C


class Corrupted(NamedTuple):
    src: torch.Tensor          # [B, L] masked token grid (model input)
    mask: torch.Tensor         # [B, L] bool, True where masked
    num_masked: torch.Tensor   # [B] realized masked counts (loss timesteps)


def sample_mask_counts(generator: torch.Generator, batch: int, D: int) -> torch.Tensor:
    """Draw the OA-ARDM ``num_mask = D - t + 1`` with t ~ U{1, D-1}."""
    t = torch.randint(1, D, (batch,), generator=generator, device=generator.device)
    return D - t + 1


def mask_from_scores(scores: torch.Tensor, counts: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """[B, L] bool mask selecting, per row, the ``counts[b]`` positions of
    smallest score among the first ``window`` (default: all)."""
    length = scores.shape[-1]
    window = length if window is None else window
    if window < length:
        scores = scores.clone()
        scores[:, window:] = 2.0  # never selected
    order = torch.argsort(scores, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    return ranks < counts[:, None]


def random_subset_mask(generator: torch.Generator, batch: int, length: int,
                       counts: torch.Tensor, window: Optional[int] = None
                       ) -> torch.Tensor:
    """[B, length] bool mask with ``counts[b]`` True entries drawn uniformly
    without replacement from the first ``window`` positions (default: all)."""
    scores = torch.rand((batch, length), generator=generator, device=generator.device)
    return mask_from_scores(scores, counts, window)


def corrupt(generator: torch.Generator, tokens: torch.Tensor, protected: torch.Tensor,
            window: Optional[int] = None) -> Corrupted:
    """Apply OA-ARDM forward masking to ``tokens`` [B, L]; ``protected``
    [B, L] bool positions are never masked; ``window`` restricts candidate
    positions to [0, window) (the camel fine-tune collater's D = 150)."""
    B, L = tokens.shape
    D = window if window is not None else L
    counts = sample_mask_counts(generator, B, D)
    mask = random_subset_mask(generator, B, L, counts, window=window)
    mask = mask & ~protected
    src = torch.where(mask, torch.full_like(tokens, C.IDX_MSK), tokens)
    return Corrupted(src=src, mask=mask, num_masked=mask.sum(dim=-1))


def pair_protected_mask(tokens: torch.Tensor, cdr_index: torch.Tensor,
                        protect_pads: bool = False) -> torch.Tensor:
    """The protected mask for the pair grid: CDR slots, and optionally grid
    pads (mouse fine-tune mode)."""
    protected = torch.broadcast_to(cdr_index != 0, tokens.shape)
    if protect_pads:
        protected = protected | (tokens == C.IDX_PAD)
    return protected
