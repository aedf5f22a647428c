"""OA-ARDM losses: masked cross-entropy with Hoogeboom reweighting.

Counterpart of hudiff_tpu/ops/losses.py:23-120 (the reference's
utils/loss.py). Mask-weighted reductions over static shapes, as the JAX
package computes them.

Reweighting semantics kept from the reference, quirks included: the
Hoogeboom term multiplies each masked token's CE by ``n_positions / t``,
where ``n_positions`` is the *padded* grid length of the chain block and
``t`` the per-sample masked count (pair model: the combined H+L count for
both chains).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import constants as C


def token_ce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position cross entropy, float32. logits [.., V], targets [..]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, targets[..., None].long())[..., 0]


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` where ``mask`` is True (0 if mask empty)."""
    mask = mask.to(values.dtype)
    denom = torch.clamp(mask.sum(), min=1.0)
    return (values * mask).sum() / denom


def masked_accuracy(logits: torch.Tensor, targets: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(logits, dim=-1)
    return masked_mean((pred == targets).float(), mask)


def _reweighted_ce(ce: torch.Tensor, mask: torch.Tensor, t: torch.Tensor,
                   n_positions: int) -> torch.Tensor:
    """Mean over masked tokens of ``n_positions / t_b * ce`` (per-sample t)."""
    w = (n_positions / torch.clamp(t, min=1).float())[:, None]
    return masked_mean(ce * w, mask)


def pair_oardm_loss(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                    cdr_mask: torch.Tensor, reweight: bool = True
                    ) -> Dict[str, torch.Tensor]:
    """Merged H+L loss. ``mask``: the OA-ARDM corruption mask; ``cdr_mask``:
    CDR positions (always given unmasked to the model; supervised
    separately)."""
    ce = token_ce(logits, targets)
    t = mask.sum(dim=-1)
    nll = masked_mean(ce, mask)
    cdr = masked_mean(ce, cdr_mask)
    ce_loss = _reweighted_ce(ce, mask, t, logits.shape[1]) if reweight else nll
    return {'ce': ce_loss, 'nll': nll, 'cdr_ce': cdr,
            'accuracy': masked_accuracy(logits, targets, mask)}


def pair_oardm_split_loss(logits: torch.Tensor, targets: torch.Tensor,
                          mask: torch.Tensor, cdr_mask: torch.Tensor,
                          l_weight: float = 1.0, reweight: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """Split H / L loss. Both chains are reweighted by the combined H+L
    masked count but by their own padded length; the light terms get
    ``l_weight``."""
    H = C.HEAVY_LEN
    ce = token_ce(logits, targets)
    h_ce, l_ce = ce[:, :H], ce[:, H:]
    h_mask, l_mask = mask[:, :H], mask[:, H:]
    h_cdr, l_cdr = cdr_mask[:, :H], cdr_mask[:, H:]
    t_total = mask.sum(dim=-1)

    h_nll = masked_mean(h_ce, h_mask)
    l_nll = masked_mean(l_ce, l_mask)
    h_cdr_loss = masked_mean(h_ce, h_cdr)
    l_cdr_loss = masked_mean(l_ce, l_cdr) * l_weight
    if reweight:
        h_loss = _reweighted_ce(h_ce, h_mask, t_total, H)
        l_loss = _reweighted_ce(l_ce, l_mask, t_total, logits.shape[1] - H) * l_weight
    else:
        h_loss, l_loss = h_nll, l_nll
    return {'h_ce': h_loss, 'h_nll': h_nll, 'h_cdr_ce': h_cdr_loss,
            'l_ce': l_loss, 'l_nll': l_nll, 'l_cdr_ce': l_cdr_loss,
            'accuracy': masked_accuracy(logits, targets, mask)}


def heavy_oardm_loss(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
                     cdr_mask: torch.Tensor, reweight: bool = True
                     ) -> Dict[str, torch.Tensor]:
    """Heavy-only loss."""
    ce = token_ce(logits, targets)
    t = mask.sum(dim=-1)
    nll = masked_mean(ce, mask)
    cdr = masked_mean(ce, cdr_mask)
    ce_loss = _reweighted_ce(ce, mask, t, logits.shape[1]) if reweight else nll
    return {'ce': ce_loss, 'nll': nll, 'cdr_ce': cdr,
            'accuracy': masked_accuracy(logits, targets, mask)}


def nano_finetune_ce(logits: torch.Tensor, targets: torch.Tensor,
                     cdr_mask: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     reconstruct: bool = False) -> Dict[str, torch.Tensor]:
    """CDR CE (+ optional reconstruct term) for the nanobody fine-tune."""
    ce = token_ce(logits, targets)
    out = {'cdr_ce': masked_mean(ce, cdr_mask)}
    if reconstruct:
        if mask is None:
            raise ValueError('nano_finetune_ce: reconstruct needs the corruption mask')
        t = mask.sum(dim=-1)
        out['reconstruct_ce'] = _reweighted_ce(ce, mask, t, logits.shape[1])
    return out
