"""Fine-tune frameworks: AbNatiV-guided humanness optimization, in PyTorch.

Counterpart of hudiff_tpu/models/finetune.py (the reference's
AntiFrameWork, model/encoder/model.py:387-719, and NanoInfillingFramework,
model/nanoencoder/model.py:346-571):

- the infilling denoiser fills the masked framework slots with Gumbel
  straight-through one-hots;
- the infilled IMGT grids go onto AHo grids through the static-shaped
  rank-matching transfer (ops/scheme_transfer.py);
- frozen AbNatiV scorers judge the infilled positions; the losses push the
  scores toward ``human_threshold``;
- the pair framework runs both light scorers (kappa and lambda) over every
  light chain and combines them with per-sample weights.

The loss builders close over the infilling model and the frozen scorers
(``abnativ.frozen``: no parameter gradient; gradients reach the scorers'
inputs, through the codebook too where the scorer has ``straight_through``).
The denoiser's logits are f32 (its decoder), and so are the Gumbel and
straight-through tensors and the scorers. In the Nb loss each scorer
forward is a device span ``scorer`` and the scorers' backward one
``scorer.backward`` (``utils.tracing``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import constants as C
from ..ops import scheme_transfer as ST
from ..utils import tracing
from . import abnativ as AB


def huber(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch ``F.smooth_l1_loss`` elementwise (beta = 1), as the JAX
    package writes it."""
    d = torch.abs(x - target)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


def _score_loss(score: torch.Tensor, threshold: float, loss_type: str,
                weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    target = torch.full_like(score, threshold)
    if loss_type == 'mse_loss':
        per = (score - target) ** 2
    elif loss_type == 'smooth_loss':
        per = huber(score, target)
    elif loss_type == 'l1_loss':
        per = torch.abs(score - target)
    else:
        raise KeyError(f'unknown loss type {loss_type}')
    if weights is None:
        return per.mean()
    return (per * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def _infilled_aho(logits, batch, u, temperature, imgt_cand, aho_cand, valid_max):
    """(infilled AHo one-hot grid, its infilled-slot mask): Gumbel
    straight-through one-hots over the 20 residues at the masked slots, the
    clean grid elsewhere, moved onto the AHo grid."""
    mask, ref, aho = batch['mask'], batch['ref'], batch['aho']
    st = ST.gumbel_straight_through(logits[..., : C.N_AA], temperature, u=u)
    st21 = torch.cat([st, st.new_zeros((*st.shape[:2], 1))], dim=-1)
    infilled = torch.where(mask[..., None], st21, ST.imgt_grid_onehot(ref, dtype=st.dtype))
    tmap = ST.build_transfer_map(ref, aho, imgt_cand, aho_cand, valid_max)
    return ST.apply_transfer(infilled, aho, tmap), ST.transfer_mask(mask, tmap)


def _scored(scorer, aho: torch.Tensor) -> torch.Tensor:
    """``scorer(aho)``, one AbNatiV forward, as the device span ``scorer``."""
    with tracing.span('scorer', device=True):
        return scorer(aho)


@dataclasses.dataclass(frozen=True)
class NanoFinetuneConfig:
    """Mirrors configs/nano_finetune.yml's model section."""
    loss_type: str = 'smooth_loss'
    vhh_nativeness: bool = True
    temperature: float = 1.0
    human_threshold: float = 1.0
    human_all_seq: bool = False
    vhh_all_seq: bool = False
    equal_weight: bool = False


LossFn = Callable[[Dict[str, torch.Tensor], torch.Tensor],
                  Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], torch.Tensor]]]


def make_nano_finetune_loss(infill_model, vh_model, cfg: NanoFinetuneConfig,
                            vhh_model=None) -> LossFn:
    """``loss_fn(batch, u) -> (loss, (metrics, logits))``.

    batch: src [B, 152] masked tokens, mask [B, 152] bool, ref [B, 152]
    clean tokens, region [B, 152], aho [B, 149, 21] one-hot of the original
    VHH; ``u`` [B, 152, 20] the Gumbel uniforms.
    """
    if cfg.vhh_nativeness and vhh_model is None:
        raise ValueError('vhh_nativeness needs the VHH scorer')

    def loss_fn(batch, u):
        logits = infill_model(batch['src'], batch['region'])
        infilled_aho, infill_aho_mask = _infilled_aho(
            logits, batch, u, cfg.temperature, ST.NANO_IMGT_CAND, ST.NANO_AHO_CAND, C.IDX_X)
        humanness = AB.nativeness_scores(_scored(vh_model, infilled_aho), infill_aho_mask, 'VH',
                                         all_seq=cfg.human_all_seq)
        vh_loss = _score_loss(humanness, cfg.human_threshold, cfg.loss_type)
        metrics = {'vh_loss': vh_loss, 'humanness_mean': humanness.mean()}
        loss = vh_loss
        if cfg.vhh_nativeness:
            old_s = AB.nativeness_scores(_scored(vhh_model, batch['aho'].detach()),
                                         infill_aho_mask, 'VHH', all_seq=cfg.vhh_all_seq)
            new_s = AB.nativeness_scores(_scored(vhh_model, infilled_aho), infill_aho_mask,
                                         'VHH', all_seq=cfg.vhh_all_seq)
            delta = torch.mean((new_s - old_s.detach()) ** 2)
            loss = vh_loss + delta
            if cfg.equal_weight:
                # equalize the gradient contribution when delta < vh_loss
                # (nanoencoder/model.py:424-434)
                ratio = (delta / torch.clamp(vh_loss, min=1e-12)).detach()
                loss = vh_loss + torch.where(
                    delta < vh_loss, delta / torch.clamp(ratio, min=1e-12), delta)
            metrics['delta_vhh'] = delta
            metrics['vhh_new_mean'] = new_s.mean()
        metrics['loss'] = loss
        tracing.backward_span('scorer.backward', loss, infilled_aho)
        return loss, (metrics, logits)

    return loss_fn


@dataclasses.dataclass(frozen=True)
class AbFinetuneConfig:
    """Mirrors configs/antibody_finetune.yml's model section."""
    loss_type: str = 'smooth_loss'
    human_threshold: float = 1.0
    all_seq: bool = False
    mutation: bool = False
    temperature: float = 1.0
    heavy_mutation_threshold: int = 17
    light_mutation_threshold: int = 15
    norm_mutation: int = 10


def make_ab_finetune_loss(infill_model, vh_model, vlk_model, vll_model,
                          cfg: AbFinetuneConfig) -> LossFn:
    """``loss_fn(batch, u) -> (loss, (metrics, logits))``.

    batch: src [B, 291], mask [B, 291] bool, ref [B, 291], region [B, 291],
    chain_type [B, 2], aho [B, 298, 21] (heavy 149 + light 149 one-hots);
    ``u`` [B, 291, 20] the Gumbel uniforms.
    """
    H = C.AHO_LEN

    def loss_fn(batch, u):
        mask, ref, chain = batch['mask'], batch['ref'], batch['chain_type']
        logits = infill_model(batch['src'], batch['region'], chain)
        infilled_aho, infill_aho_mask = _infilled_aho(
            logits, batch, u, cfg.temperature, ST.PAIR_IMGT_CAND, ST.PAIR_AHO_CAND, C.IDX_PAD)
        aho_h, aho_l = infilled_aho[:, :H], infilled_aho[:, H:]
        m_h, m_l = infill_aho_mask[:, :H], infill_aho_mask[:, H:]

        s_h = AB.nativeness_scores(vh_model(aho_h), m_h, 'VH', all_seq=cfg.all_seq)
        vh_loss = _score_loss(s_h, cfg.human_threshold, cfg.loss_type)
        is_kappa = (chain[:, 1] == C.CHAIN_TYPES['K']).float()
        is_lambda = 1.0 - is_kappa
        s_k = AB.nativeness_scores(vlk_model(aho_l), m_l, 'VKappa', all_seq=cfg.all_seq)
        s_l = AB.nativeness_scores(vll_model(aho_l), m_l, 'VLambda', all_seq=cfg.all_seq)
        if cfg.loss_type == 'smooth_loss':
            # the reference sums the per-light-chain losses and divides by B
            # (encoder/model.py:496-514)
            per_l = (huber(s_k, torch.full_like(s_k, cfg.human_threshold)) * is_kappa
                     + huber(s_l, torch.full_like(s_l, cfg.human_threshold)) * is_lambda)
            vl_loss = per_l.sum() / s_k.shape[0]
        else:
            vl_loss = (_score_loss(s_k, cfg.human_threshold, cfg.loss_type, is_kappa)
                       + _score_loss(s_l, cfg.human_threshold, cfg.loss_type, is_lambda))
        ab_loss = vh_loss + vl_loss
        metrics = {'vh_loss': vh_loss, 'vl_loss': vl_loss, 'ab_score_loss': ab_loss,
                   'vh_score_mean': s_h.mean()}
        loss = ab_loss
        if cfg.mutation:
            # a hinge on mutation counts, from the argmax: no gradient, as
            # in the reference (encoder/model.py:523-558)
            changed = (torch.argmax(logits, dim=-1) != ref) & mask
            h_mut = changed[:, : C.HEAVY_LEN].sum(-1)
            l_mut = changed[:, C.HEAVY_LEN:].sum(-1)
            h_pen = torch.clamp((h_mut - cfg.heavy_mutation_threshold) / cfg.norm_mutation,
                                min=0).mean()
            l_pen = torch.clamp(((l_mut - cfg.light_mutation_threshold)
                                 / cfg.norm_mutation) ** 2, min=0).mean()
            metrics['h_mutation_loss'] = h_pen
            metrics['l_mutation_loss'] = l_pen
            loss = loss + h_pen + l_pen
        metrics['loss'] = loss
        return loss, (metrics, logits)

    return loss_fn


def mask_low_score_residues(tokens: torch.Tensor, residue_scores: torch.Tensor,
                            tmap: ST.TransferMap, cdr_mask: torch.Tensor,
                            threshold: float = 0.988047) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask framework residues whose AbNatiV residue score is below the VH
    threshold (reference mask_residues, nanoencoder/model.py:484-501).

    residue_scores: [B, 149] per-position exp(-recon_error). Each AHo
    slot's score goes back to the IMGT slot that fed it. Returns (masked
    tokens, new mask)."""
    B, L = tokens.shape
    safe_src = torch.where(tmap.src >= 0, tmap.src, L)
    imgt_scores = torch.ones((B, L + 1), dtype=residue_scores.dtype,
                             device=residue_scores.device).scatter_(1, safe_src, residue_scores)
    to_mask = (imgt_scores[:, :L] < threshold) & ~cdr_mask
    return torch.where(to_mask, torch.full_like(tokens, C.IDX_MSK), tokens), to_mask
