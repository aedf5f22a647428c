"""What the training drivers share: a pool of batches made at set-up and
cycled, the three checked steps driven through the window's own call, and
the comparison of their loss, first gradient and parameter change with the
reference's (``reference/train.py``).

The model trains in train mode, at the configuration's dropout after each
ByteNet block and the position embedder's fixed 0.5. The masks are drawn
by the program from torch's generator, seeded from the run's seed. During
the three checked steps, hooks read each site's output after its dropout
(a ByteNet block's is the next block's input, or the tower's output; the
position MLP's is its output) and keep the elements that are not zero as
the kept mask, on the host. An element that was exactly zero before its
dropout reads as dropped: its value is zero either way. The reference
applies these masks with its own scale (``reference.denoiser.dropped``).
The check also holds each site's dropped share to its p
(``dropout_share_gap``), so that the masks the reference follows are the
configuration's. The hooks are removed before the window.

A driver subclasses ``StepDriver`` and defines ``_build()`` (the model, the
training state ``self.state``, the step ``self.step``, the batch pool
``self.pool``, ``self.params`` and ``self.batch_size``), ``_step(batch,
corrupted)`` (one call of the step) and ``_reference(mm)`` (the reference's
losses, first gradients and parameters over ``self.checked``, each with
its ``drop``).
"""
from __future__ import annotations

import torch

from benchmark import generate as G
from benchmark.harness import log
from benchmark.reference import denoiser as R
from benchmark.reference import train as RT

from hudiff_tpu_torch.models.embedders import GatedMLP
from hudiff_tpu_torch.ops.bytenet import ByteNetStack
from hudiff_tpu_torch.ops.masking import Corrupted

CHECKED_STEPS = 3


class DropoutReader:
    """Hooks on ``model`` that keep, for each forward, every dropout site's
    kept elements (bool, on the host) in ``self.masks``, and each site's p;
    ``read(batch)`` hands a checked step's masks to its batch (``drop``)."""

    def __init__(self, model, cfg: dict):
        self.masks, self.p, self.handles = {}, {}, []
        self.share_gap = 0.0
        for name, m in model.named_modules():
            if isinstance(m, ByteNetStack):
                sites = [f'{name}.blocks.{i}' for i in range(len(m.blocks))]
                for i, block in enumerate(m.blocks[1:]):
                    self.handles.append(block.register_forward_pre_hook(
                        self._reader(sites[i], lambda args, out: args[0])))
                self.handles.append(m.register_forward_hook(
                    self._reader(sites[-1], lambda args, out: out)))
                self.p.update({s: cfg['dropout'] for s in sites})
            elif isinstance(m, GatedMLP):
                self.handles.append(m.register_forward_hook(
                    self._reader(name, lambda args, out: out)))
                self.p[name] = R.POS_MLP_DROPOUT

    def _reader(self, site, pick):
        def hook(module, args, out=None):
            self.masks[site] = (pick(args, out).detach() != 0).cpu()
        return hook

    def read(self, batch: dict) -> None:
        """The last forward's masks over the batch's rows: a site that saw
        fewer (a step that left rows out) has the rest kept, so that the
        reference still follows every row. ``share_gap``: the largest gap so
        far, over the sites, of the dropped share from p, as a share of p."""
        masks, self.masks = self.masks, {}
        rows = len(batch['tokens'])
        batch['drop'] = {k: torch.cat([m, m.new_ones((rows - len(m),) + m.shape[1:])])
                         for k, m in masks.items()}
        self.share_gap = max([self.share_gap] + [
            abs(1.0 - float(m.float().mean()) - self.p[k]) / self.p[k]
            for k, m in batch['drop'].items() if self.p[k] > 0])

    def remove(self):
        for h in self.handles:
            h.remove()


class StepDriver:
    def __init__(self, run):
        self.run, self.t = run, run.traffic
        self.dev = run.device
        self.tables = G.imgt()
        self.losses = []

    def setup(self):
        model, beta1 = self._build()
        model.train()
        torch.manual_seed(int(G.seed_sequence(self.run.seed, 5).integers(2 ** 62)))
        self.n_steps = 0
        self.checked = []
        dropout = DropoutReader(model, self.run.cfg)
        readers = [dropout] + self._readers()
        for i in range(CHECKED_STEPS):
            self.checked.append(self.unit(keep=True))
            for r in readers:
                r.read(self.checked[-1])
            if i == 0:
                state = self.state.optimizer.state    # empty if the step left Adam alone
                self.first_grad = {n: (state[p]['exp_avg'].detach().clone() / (1 - beta1)
                                       if p in state else torch.zeros_like(p))
                                   for n, p in model.named_parameters()}
        for r in readers:
            r.remove()
        self.dropout_share_gap = dropout.share_gap
        self.after = {n: p.detach().clone() for n, p in model.named_parameters()}
        self.run.mark('checked steps')
        for _ in range(self.t['warm_steps']):
            self.unit()
        self.losses.clear()

    def unit(self, keep: bool = False):
        b = self.pool[self.n_steps % len(self.pool)]
        tokens, mask = b['tokens'], b['mask']
        cor = Corrupted(src=torch.where(mask, torch.full_like(tokens, int(self.tables['idx_msk'])),
                                        tokens), mask=mask, num_masked=mask.sum(dim=-1))
        with self.run.span('step'):
            m = self._step(b, cor)
        self.n_steps += 1
        self.losses.append(m['loss'])
        return dict(b, loss=m['loss']) if keep else None

    def settle(self):
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)

    def end_to_end(self, units, seconds):
        return {'train_samples_per_s': units * self.batch_size / seconds}

    def attempted(self):
        return len(self.losses)

    def failed(self):
        return int((~torch.isfinite(torch.stack(self.losses))).sum()) if self.losses else 0

    def release(self):
        self.losses_checked = [float(b['loss']) for b in self.checked]
        del self.state, self.step
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()

    def _readers(self) -> list:
        """More readers of the checked steps (``read(batch)``, ``remove()``)."""
        return []

    def _choice_numbers(self, chose, c_chose=None) -> dict:
        """Numbers of the choices the reference followed (none here)."""
        return {}

    def check(self, control=False, mm=None):
        """The compared numbers beside their limits; with ``control`` the
        control's too (``mm``, fp8 by default, in the program's place), and
        every number ``compare`` reads, under ``all_``."""
        losses, first, params, chose = self._reference(R.identity)
        change_r = {k: params[k] - self.params[k] for k in self.params}
        change_p = {k: self.after[k] - self.params[k] for k in self.params}
        got = RT.compare(self.losses_checked, losses, self.first_grad, first, change_p, change_r)
        got.update(self._choice_numbers(chose), dropout_share_gap=self.dropout_share_gap)
        self.worst = got.pop('worst')
        self.readings = dict(got)
        log(f'worst leaves (name, gap, reference norm, program norm, sign flips): {self.worst}')
        lim = self.run.cell.spec['limits']
        out = {k: (v, lim[k]) for k, v in got.items() if k in lim}
        if control:
            c_losses, c_first, c_params, c_chose = self._reference(mm or R.fp8_round)
            c_change = {k: c_params[k] - self.params[k] for k in self.params}
            ctrl = RT.compare(c_losses, losses, c_first, first, c_change, change_r)
            ctrl.update(self._choice_numbers(chose, c_chose))
            log(f"control's worst leaves: {ctrl.pop('worst')}")
            out.update({f'control_{k}': (v, lim.get(k)) for k, v in ctrl.items()})
            out.update({f'all_{k}': (v, lim.get(k)) for k, v in got.items()})
        return out
