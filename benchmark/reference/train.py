"""The reference's training steps, in plain float32 PyTorch.

One step, as HuDiff's pretraining defines it: the corrupted grid (the
masked slots set to <msk>) through the denoiser (``denoiser.py``); the
OA-ARDM loss of the ``merge`` type, the mean over masked slots of each
slot's cross-entropy times (grid length / the row's masked count), plus the
mean cross-entropy over the CDR slots; the backward; the gradients clipped
to a global norm (scale min(1, clip / (norm + 1e-6))); Adam with the
weight decay added to the gradient (L2), bias-corrected moments and eps
1e-8. The batch runs in blocks of rows whose gradients add up to the
batch's (the loss's denominators are the batch's).

``compare`` reads numbers from the program's state against the
reference's: the worst step's loss gap; the gap of each leaf's first
gradient norm (as Adam received it) and of each leaf's change after the
steps, relative to the reference's value or the median leaf's, whichever
is larger, by the worst leaf, the leaf at the 90th and 95th percentiles and
the median leaf. Leaves whose reference gradient is under a thousandth of
the median leaf's are left out of the change.

A step's ``drop`` (``denoiser.dropped``) holds the program's dropout masks
of the batch's rows; the reference scales and applies them itself.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from .denoiser import identity, no_tf32


def merge_loss_parts(logits, tokens, mask, cdr, den_mask, den_cdr):
    """This block's share of the batch's ``merge`` loss."""
    ce = -torch.gather(torch.log_softmax(logits.float(), dim=-1), -1, tokens[..., None])[..., 0]
    w = tokens.shape[1] / mask.sum(dim=-1).clamp_min(1).float()
    return (ce * w[:, None] * mask).sum() / den_mask + (ce * cdr).sum() / den_cdr


def rows(drop, s: int, e: int):
    """The dropout masks of rows [s, e)."""
    return {k: v[s:e] for k, v in drop.items()} if drop else None


def loss_and_grads(logits_fn: Callable, params: Dict[str, torch.Tensor], cfg: dict,
                   tokens, cond: Sequence, mask, cdr_row, msk: int, mm: Callable = identity,
                   block: int = 32, drop=None):
    """(loss, {name: gradient}) of one batch: ``tokens`` [B, L] clean,
    ``mask`` [B, L] bool, ``cond`` the conditioning tensors [B, ...],
    ``drop`` the dropout masks [B, ...] by site."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    B = tokens.shape[0]
    cdr = (cdr_row != 0).float().expand(B, -1)
    den_mask = mask.sum().clamp_min(1).float()
    den_cdr = cdr.sum().clamp_min(1)
    src = torch.where(mask, torch.full_like(tokens, msk), tokens)
    total = 0.0
    for s in range(0, B, block):
        e = min(B, s + block)
        logits = logits_fn(leaves, cfg, src[s:e], *(c[s:e] for c in cond), mm=mm,
                           drop=rows(drop, s, e))
        part = merge_loss_parts(logits, tokens[s:e], mask[s:e].float(), cdr[s:e], den_mask,
                                den_cdr)
        part.backward()
        total += float(part.detach())
    return total, {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                   for k, v in leaves.items()}


class Adam:
    """Adam with L2 weight decay into the gradient, after a global-norm clip."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, betas, weight_decay: float,
                 clip: float, eps: float = 1e-8):
        self.p = {k: v.detach().clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.lr, (self.b1, self.b2), self.wd = lr, betas, weight_decay
        self.clip, self.eps = clip, eps
        self.t = 0

    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Applies one update; returns the gradients as Adam received them."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = torch.clamp(self.clip / (norm + 1e-6), max=1.0)
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        got = {}
        for k, p in self.p.items():
            g = grads[k] * scale + self.wd * p
            got[k] = g
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = self.v[k].sqrt() / bc2 ** 0.5 + self.eps
            p.sub_(self.lr / bc1 * self.m[k] / denom)
        return got


def run_steps(logits_fn: Callable, params, cfg: dict, batches: List[dict], cdr_row, msk: int,
              opt: dict, mm: Callable = identity):
    """The reference over ``batches`` (each ``tokens``, ``cond``, ``mask``,
    ``drop``): (losses, the first step's gradients as Adam received them,
    the parameters after the last step, None: no choice to follow)."""
    adam = Adam(params, opt['lr'], (opt['beta1'], opt['beta2']), opt['weight_decay'],
                opt['clip_norm'])
    losses, first = [], None
    with no_tf32():
        for b in batches:
            loss, grads = loss_and_grads(logits_fn, adam.p, cfg, b['tokens'], b['cond'],
                                         b['mask'], cdr_row, msk, mm, drop=b.get('drop'))
            losses.append(loss)
            got = adam.step(grads)
            first = got if first is None else first
    return losses, first, adam.p, None


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in d.items()}


def _quantile(d: Dict[str, float], q: float) -> float:
    return float(torch.tensor(list(d.values()), dtype=torch.float64).quantile(q))


def compare(losses_p, losses_r, grad_p, grad_r, change_p, change_r) -> Dict[str, float]:
    """The gaps of the module's docstring, and under ``worst`` the five
    worst leaves of each (name, gap, reference norm, program norm, the share
    of the leaf's elements whose first gradient has the other sign)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses_p, losses_r))
    gp, gr = _norms(grad_p), _norms(grad_r)
    g_med = float(torch.tensor(list(gr.values())).median())
    grad = {k: abs(gp[k] - gr[k]) / max(gr[k], g_med) for k in gr}
    cp, cr = _norms(change_p), _norms(change_r)
    moved = [k for k in cr if gr[k] >= 1e-3 * g_med]
    c_med = float(torch.tensor([cr[k] for k in moved]).median())
    change = {k: abs(cp[k] - cr[k]) / max(cr[k], c_med) for k in moved}
    out = {'loss_gap': loss_gap}
    for what, gaps in (('grad', grad), ('change', change)):
        out.update({f'{what}_gap': max(gaps.values()), f'{what}_gap_p95': _quantile(gaps, 0.95),
                    f'{what}_gap_p90': _quantile(gaps, 0.9),
                    f'{what}_gap_median': _quantile(gaps, 0.5)})

    def flips(k):
        return float((torch.sign(grad_p[k]) != torch.sign(grad_r[k])).float().mean())
    norms = {'grad': (gr, gp), 'change': (cr, cp)}
    out['worst'] = {what: [[k, gaps[k], norms[what][0][k], norms[what][1][k], flips(k)]
                           for k in sorted(gaps, key=gaps.get, reverse=True)[:5]]
                    for what, gaps in (('grad', grad), ('change', change))}
    return out
