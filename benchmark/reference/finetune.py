"""The reference's nanobody fine-tuning step, in plain float32 PyTorch.

HuDiff-Nb's fine-tuning (TencentAI4S/HuDiff, ``model/nanoencoder/model.py``,
``configs/training_nano_framework.yml``), frozen AbNatiV scorers
(``abnativ_model.py``, ``abnativ_vq.py``, ``abnativ_scoring.py``):

- AbNatiV on an AHo one-hot [B, 149, 21]: Conv1d(21 -> 128, k 4, stride 2,
  padding 1) embedding plus a sinusoidal table; 4 post-norm blocks
  ``x = LN(x + MHA(x)); x = LN(x + W2 relu(W1 x))`` (4 heads, d_ff 256, q
  scaled by 1/sqrt(head dim)); the codebook lookup by cosine similarity
  (project 128 -> 32, argmax over 512 codes, the code itself, project back);
  the table again, 4 more blocks, ConvTranspose1d(128 -> 21, k 4, stride
  2) cropped to [1, 150), a softmax over the alphabet; the error a
  position is the mean square of reconstruction minus input;
- a nativeness score: exp(-mean error over the scored positions), rescaled
  so that the model's threshold maps to 0.8; a row with none scores 1;
- the step: the denoiser's logits on the corrupted grid (the program's
  dropout masks applied, ``denoiser.dropped``); at the masked
  slots a Gumbel straight-through one-hot over the 20 residues (the hard
  argmax forward, the softmax's gradient back) with the given uniforms,
  the clean grid elsewhere (pad as AbNatiV's gap); the k-th residue of the
  first 150 IMGT slots moved onto the k-th residue slot of the first 147
  AHo slots; the loss ``smooth_l1(VH score, 1) + mean((VHH score of the
  infilled - VHH score of the input)^2) + CDR cross-entropy``, both scores
  over the AHo slots the masked slots reached; the backward into the
  denoiser only; the clip and Adam of ``train.py``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .denoiser import heavy_logits, identity, no_tf32
from .train import Adam, rows

LN_EPS = 1e-6


def _sinusoidal(d: int, length: int, device) -> torch.Tensor:
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-np.log(10000.0) / d))
    pe = np.zeros((length, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.tensor(pe, dtype=torch.float32, device=device)


def _block(x, p, n, heads, mm):
    B, L, d = x.shape
    hd = d // heads
    qkv = F.linear(mm(x), mm(p[f'{n}.self_MHA.in_proj_weight']), p[f'{n}.self_MHA.in_proj_bias'])
    q, k, v = (t.reshape(B, L, heads, hd).transpose(1, 2) for t in qkv.chunk(3, -1))
    w = torch.softmax(mm(q / math.sqrt(hd)) @ mm(k).transpose(-1, -2), dim=-1)
    a = (mm(w) @ mm(v)).transpose(1, 2).reshape(B, L, d)
    a = F.linear(mm(a), mm(p[f'{n}.self_MHA.out_proj.weight']), p[f'{n}.self_MHA.out_proj.bias'])
    x = F.layer_norm(x + a, (d,), p[f'{n}.layernorm1.weight'], p[f'{n}.layernorm1.bias'], LN_EPS)
    h = F.relu(F.linear(mm(x), mm(p[f'{n}.MLperceptron.0.weight']), p[f'{n}.MLperceptron.0.bias']))
    h = F.linear(mm(h), mm(p[f'{n}.MLperceptron.3.weight']), p[f'{n}.MLperceptron.3.bias'])
    return F.layer_norm(x + h, (d,), p[f'{n}.layernorm2.weight'], p[f'{n}.layernorm2.bias'], LN_EPS)


def abnativ_errors(p: Dict[str, torch.Tensor], hp: dict, x: torch.Tensor,
                   mm: Callable = identity) -> torch.Tensor:
    """The reconstruction error a position [B, 149] of one-hots ``x``."""
    w = p['encoder.cnn_embedding.1.weight']
    h = F.conv1d(mm(x).transpose(1, 2), mm(w), p['encoder.cnn_embedding.1.bias'],
                 stride=hp['stride'], padding=1).transpose(1, 2)
    pe = _sinusoidal(h.shape[-1], h.shape[1], x.device)
    h = h + pe
    for i in range(hp['num_mha_layers']):
        h = _block(h, p, f'encoder.en_MHA_blocks.{i}', hp['num_heads'], mm)
    z = F.linear(mm(h), mm(p['vqvae.project_in.weight']), p['vqvae.project_in.bias'])
    embed = p['vqvae._codebook.embed']
    zn = z / (z.norm(dim=-1, keepdim=True) + 1e-12)
    en = embed / (embed.norm(dim=-1, keepdim=True) + 1e-12)
    code = embed[torch.argmax(zn @ en.t(), dim=-1)]
    q = F.linear(mm(code), mm(p['vqvae.project_out.weight']), p['vqvae.project_out.bias'])
    z = q + pe
    for i in range(hp['num_mha_layers']):
        z = _block(z, p, f'decoder.de_MHA_blocks.{i}', hp['num_heads'], mm)
    r = F.conv_transpose1d(mm(z).transpose(1, 2), mm(p['decoder.cnn_reconstruction.1.weight']),
                           p['decoder.cnn_reconstruction.1.bias'], stride=hp['stride'])
    r = r.transpose(1, 2)[:, 1:1 + hp['length_seq']]
    r = torch.softmax(r, dim=-1)
    return ((r - x) ** 2).mean(dim=-1)


def score(err, mask, threshold: float, target: float) -> torch.Tensor:
    m = mask.float()
    n = m.sum(-1)
    raw = torch.exp(-(err * m).sum(-1) / n.clamp_min(1.0))
    s = (target - 1.0) / (threshold - 1.0) * (raw - 1.0) + 1.0
    return torch.where(n == 0, torch.ones_like(s), s)


def transfer(imgt_onehot, imgt_tokens, aho_onehot, n_imgt: int, n_aho: int, valid_max: int,
             gap: int):
    """(AHo one-hots with the IMGT residues moved in, the AHo mask of moved
    slots' source mask): the k-th IMGT residue slot of the first ``n_imgt``
    onto the k-th non-gap slot of the first ``n_aho``."""
    B, L_aho, V = aho_onehot.shape
    iv = imgt_tokens[:, :n_imgt] < valid_max
    av = aho_onehot[:, :n_aho].argmax(-1) != gap
    src = torch.full((B, L_aho), -1, dtype=torch.long, device=imgt_tokens.device)
    for b in range(B):
        islots = torch.nonzero(iv[b])[:, 0]
        aslots = torch.nonzero(av[b])[:, 0]
        n = min(len(islots), len(aslots))
        src[b, aslots[:n]] = islots[:n]
    gathered = torch.gather(imgt_onehot, 1, src.clamp_min(0)[..., None].expand(-1, -1, V))
    return torch.where((src < 0)[..., None], aho_onehot, gathered), src


def _to_imgt(follow_aho, src_map, L: int):
    """[B, L] of the AHo slots' tokens ``follow_aho`` [B, 149] put back on the
    IMGT slots they were moved from (``transfer``'s ``src_map``); -1 where
    none was moved."""
    B = src_map.shape[0]
    idx = torch.where(src_map >= 0, src_map, L)
    out = torch.full((B, L + 1), -1, dtype=torch.long, device=src_map.device)
    return out.scatter_(1, idx, follow_aho.to(src_map.device).long())[:, :L]


def finetune_loss_and_grads(params, cfg: dict, hp: dict, scorers: dict, consts: dict, batch: dict,
                            cdr_row, msk: int, pad: int, mm: Callable = identity,
                            block: int = 128):
    """(loss, {name: gradient}, what it chose) of one batch: ``tokens``
    [B, 152] clean, ``aho`` [B, 149, 21], ``mask`` [B, 152], ``u`` [B, 152,
    20], ``region``, ``drop`` (the program's dropout masks by site,
    ``denoiser.dropped``) and ``follow``.

    ``follow`` [B, 149], where given, is the program's straight-through
    choice as its VH scorer read it (each AHo slot's token; -1 for a row the
    program did not score). At every masked slot that reaches the scorers
    the reference takes the program's choice
    instead of its own argmax, as a served model's tokens are teacher-forced,
    so that a choice that rounding tipped over a near-tie does not move the
    rest of the comparison. What it chose: ``logits`` [B, 152, 20] (the
    residues' logits), ``pert`` (the same perturbed), ``choice`` [B, 152]
    (its own argmax), ``at`` [B, 152] (the slots that reach the scorers) and
    ``gap``, the widest gap by which a followed choice's perturbed logit
    lies below the best."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    tokens, aho, mask, u = batch['tokens'], batch['aho'], batch['mask'], batch['u']
    follow = batch.get('follow')
    B, L = tokens.shape
    cdr = (cdr_row != 0).float().expand(B, -1)
    den_cdr = cdr.sum()
    src = torch.where(mask, torch.full_like(tokens, msk), tokens)
    thr, target = consts['best_thresholds'], consts['rescale_target']
    gap, n_aa = consts['gap_idx'], consts['gap_idx']
    total, chose = 0.0, {'logits': [], 'pert': [], 'choice': [], 'at': [], 'gap': 0.0}
    for s in range(0, B, block):
        e = min(B, s + block)
        logits = heavy_logits(leaves, cfg, src[s:e], batch['region'][s:e], None, mm,
                              rows(batch.get('drop'), s, e))
        g = -torch.log(-torch.log(u[s:e] + 1e-20) + 1e-20)
        pert = logits[..., :n_aa].float() + g
        probs = torch.softmax(pert, dim=-1)
        clean = (torch.where(tokens[s:e] == pad, gap, tokens[s:e])[..., None]
                 == torch.arange(gap + 1, device=tokens.device)).float()
        _, src_map = transfer(clean, tokens[s:e], aho[s:e], consts['nano_imgt_candidates'],
                              consts['nano_aho_candidates'], consts['idx_x'], gap)
        own = pert.argmax(-1)
        at = (_to_imgt(torch.ones_like(src_map), src_map, L) > 0) & mask[s:e]
        choice = own
        if follow is not None:
            theirs = _to_imgt(follow[s:e], src_map, L)
            use = at & (theirs >= 0) & (theirs < n_aa)
            choice = torch.where(use, theirs, own)
            below = pert.amax(-1) - torch.gather(pert, -1, choice[..., None])[..., 0]
            chose['gap'] = max(chose['gap'], float(below[use].max()) if use.any() else 0.0)
        chose['logits'].append(logits[..., :n_aa].detach().float().cpu())
        chose['pert'].append(pert.detach().cpu())
        chose['choice'].append(own.cpu())
        chose['at'].append(at.cpu())
        hard = F.one_hot(choice, n_aa).float()
        st = hard - probs.detach() + probs
        st21 = torch.cat([st, st.new_zeros(*st.shape[:2], 1)], dim=-1)
        infilled = torch.where(mask[s:e, :, None], st21, clean)
        moved, src_map = transfer(infilled, tokens[s:e], aho[s:e], consts['nano_imgt_candidates'],
                                  consts['nano_aho_candidates'], consts['idx_x'], gap)
        m_aho = (src_map >= 0) & torch.gather(mask[s:e], 1, src_map.clamp_min(0))
        vh = score(abnativ_errors(scorers['vh'], hp, moved, mm), m_aho, thr['VH'], target)
        d = (vh - 1.0).abs()
        vh_loss = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).sum() / B
        with torch.no_grad():
            old = score(abnativ_errors(scorers['vhh'], hp, aho[s:e], mm), m_aho, thr['VHH'],
                        target)
        new = score(abnativ_errors(scorers['vhh'], hp, moved, mm), m_aho, thr['VHH'], target)
        delta = ((new - old) ** 2).sum() / B
        ce = -torch.gather(torch.log_softmax(logits.float(), -1), -1, tokens[s:e, :, None])[..., 0]
        part = vh_loss + delta + (ce * cdr[s:e]).sum() / den_cdr
        part.backward()
        total += float(part.detach())
    chose.update({k: torch.cat(chose[k]) for k in ('logits', 'pert', 'choice', 'at')})
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in leaves.items()}, chose


def choice_gap(chose: List[dict], choices: List[torch.Tensor]) -> float:
    """The widest gap by which ``choices`` (a step's [B, 152] each) lie
    below the best of the reference's perturbed logits (``chose``, one a
    step) at the slots that reach the scorers."""
    out = 0.0
    for c, k in zip(chose, choices):
        below = c['pert'].amax(-1) - torch.gather(c['pert'], -1, k[..., None])[..., 0]
        out = max(out, float(below[c['at']].max()) if c['at'].any() else 0.0)
    return out


def logits_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The norm of the logits' difference as a share of the reference's; a
    row the program did not compute (NaN) reads as zeros."""
    got = torch.nan_to_num(got.double(), nan=0.0)
    return float((got - want.double()).norm() / want.double().norm())


def run_steps(params, cfg, hp, scorers, consts, batches, cdr_row, msk, pad, opt,
              mm: Callable = identity):
    """The reference over ``batches``: (losses, the first step's gradients
    as Adam received them, the parameters after the last step, what each
    step chose)."""
    adam = Adam(params, opt['lr'], (opt['beta1'], opt['beta2']), opt['weight_decay'],
                opt['clip_norm'])
    losses, first, chose = [], None, []
    with no_tf32():
        for b in batches:
            loss, grads, c = finetune_loss_and_grads(adam.p, cfg, hp, scorers, consts, b,
                                                     cdr_row, msk, pad, mm)
            losses.append(loss)
            chose.append(c)
            got = adam.step(grads)
            first = got if first is None else first
    return losses, first, adam.p, chose
