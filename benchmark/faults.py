"""Faults planted under the timed path, for the tests and the readings that
show the check catches them (``calibrate.py --fault``). Each is a context
manager that patches one of the program's functions and restores it:

- ``altered_token``: every served row's first ordered slot changed after
  the draw (a token altered where it is produced);
- ``unchanged_state``: the optimizer step skipped (a step that returns the
  state unchanged);
- ``half_batch``: the pretraining loss taken over the first half of the
  batch (half of the batch left out, the mean over the rest);
- ``half_batch_finetune``: the fine-tuning step's loss over the first half
  of its batch;
- ``no_dropout``: the training steps' dropout left out (the step the
  configuration does not state);
- ``dropped_candidate``: the nanobody filter drops the last candidate of a
  round that it should keep;
- ``skipped_filter``: the nanobody filter left out, every candidate kept
  unchecked.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from hudiff_tpu_torch.ops import losses
from hudiff_tpu_torch.sampling import humanize as HZ
from hudiff_tpu_torch.sampling import sampler as S
from hudiff_tpu_torch.training import finetune as FTT
from hudiff_tpu_torch.training import train_step as T


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def altered_token():
    make = S.make_model_sampler

    def make_altered(model, positions_per_step=1):
        inner = make(model, positions_per_step=positions_per_step)

        def run_round(tokens, order, generator, *cond, rows=None):
            out = inner(tokens, order, generator, *cond, rows=rows).clone()
            first = order[:, 0].clamp_min(0)
            ix = torch.arange(out.shape[0], device=out.device)
            out[ix, first] = (out[ix, first] + 1) % 20
            return out
        return run_round
    return _patched(S, 'make_model_sampler', make_altered)


def unchanged_state():
    def no_update(self):
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
    return _patched(T.TrainState, 'apply_gradients', no_update)


def half_batch():
    loss = losses.pair_oardm_loss

    def half(logits, targets, mask, cdr_mask, reweight=True):
        h = logits.shape[0] // 2
        return loss(logits[:h], targets[:h], mask[:h], cdr_mask[:h], reweight)
    return _patched(losses, 'pair_oardm_loss', half)


def half_batch_finetune():
    apply = FTT._apply

    def half(state, total_loss, gen, args, corrupted, u):
        h = args[0].shape[0] // 2
        cor = type(corrupted)(*(t[:h] for t in corrupted))
        return apply(state, total_loss, gen, tuple(a[:h] for a in args), cor, u[:h])
    return _patched(FTT, '_apply', half)


def no_dropout():
    def kept(x, p=0.5, training=True, inplace=False):
        return x
    return _patched(F, 'dropout', kept)


def dropped_candidate():
    result = HZ._nano_result

    def fewer(inp, out):
        return result(inp, out[:-1])
    return _patched(HZ, '_nano_result', fewer)


def skipped_filter():
    def unfiltered(self, inp, out):
        seqs = [HZ._TOK.idx2seq(row) for row in out]
        best = HZ.select_most_similar(inp['clean'], out)
        return {'seqs': seqs, 'grids': out, 'best_idx': best, 'best': seqs[best]}
    return _patched(HZ.NanoHumanizer, '_filtered', unfiltered)


FAULTS = {f.__name__: f for f in (altered_token, unchanged_state, half_batch,
                                  half_batch_finetune, no_dropout, dropped_candidate,
                                  skipped_filter)}
