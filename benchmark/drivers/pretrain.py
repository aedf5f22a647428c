"""Pretraining steps of the paired denoiser on batches made at set-up.

Traffic parameters (``traffic/<mix>.json``): ``pool`` (batches made from the
seed at set-up, on the card, and cycled: random residues with ``pad_share``
of the slots empty, as IMGT grids leave insertion slots empty, light chains
kappa or lambda, every row distinct; each batch with an OA-ARDM corruption
that spares the CDRs) and ``warm_steps``. The optimizer, clip, loss and
batch are the configuration's ``train`` section, the compute type its
``dtype``. The batches are made ahead: fed through the OAS loader
(``data.oas`` / ``data.pipeline``), whose Python competes with the step's
own for the interpreter lock, the rate spread by 14-18% between runs on
one card.

The model is in train mode, at the configuration's dropout (``_steps.py``
says how the reference follows the masks).

Set-up builds one training state (``training.train_step.TrainState`` with
the configuration's Adam) and one step (``make_pair_train_step``), and
drives them from the seed through their first three steps, the checked
ones, through the same call as the window; then ``warm_steps`` more. A unit
is one step on the next batch of the pool, its corruption handed in as the
step's ``corrupted``. The window counts whole steps and ends in a
synchronize.

The check, once the window has closed: the reference
(``reference/train.py``) follows the three steps from the same weights,
batches, corruption and dropout masks.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import generate as G
from benchmark import weights
from benchmark import yardstick as Y
from benchmark.drivers._steps import StepDriver
from benchmark.reference import denoiser as R
from benchmark.reference import train as RT

from hudiff_tpu_torch.models.denoiser import AntiTFNet, DenoiserConfig
from hudiff_tpu_torch.training import schedules
from hudiff_tpu_torch.training import train_step as T
from hudiff_tpu_torch.utils.config import Namespace

class Driver(StepDriver):
    kind = 'pair'

    def _pool(self, rng, B):
        t = self.tables
        hl, ll = int(t['heavy_len']), int(t['light_len'])
        n = self.t['pool']
        grids = G.pair_grids(n * B, hl, ll, self.t['pad_share'], rng)
        types = t['chain_types']
        chain = np.stack([np.full(n * B, types['H']),
                          rng.choice([types['K'], types['L']], n * B)], axis=1)
        self.cdr_row = np.concatenate([t['heavy_cdr_index'], t['light_cdr_index']])
        masks = G.oardm_masks(n, B, hl + ll, self.cdr_row != 0, rng)
        region = np.concatenate([t['heavy_region_index'], t['light_region_index']])
        put = lambda a: torch.as_tensor(a, dtype=torch.long, device=self.dev)  # noqa: E731
        return [{'tokens': put(grids[k * B:(k + 1) * B]), 'chain': put(chain[k * B:(k + 1) * B]),
                 'region': put(np.repeat(region[None], B, axis=0)),
                 'mask': torch.as_tensor(masks[k], device=self.dev)} for k in range(n)]

    def _build(self):
        rng = G.seed_sequence(self.run.seed, 1)
        self.train = self.run.cfg['train']
        cfg = DenoiserConfig.from_dict(self.run.cfg)
        model = AntiTFNet(cfg, dtype=getattr(torch, self.run.cfg['dtype']), device=self.dev)
        shapes = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
        self.params = weights.make(shapes, self.run.seed, self.dev)
        model.load_state_dict(self.params)
        self.run.mark('model')
        opt = self.train['optimizer']
        self.state = T.TrainState(model, schedules.make_optimizer(Namespace(opt),
                                                                 model.parameters()),
                                  clip_norm=self.train['clip_norm'])
        self.step = T.make_pair_train_step(model, loss_type=self.train['loss_type'],
                                           l_weight=self.train['l_loss_weight'])
        self.run.mark('optimizer')
        self.batch_size = self.train['batch_size']
        self.pool = self._pool(rng, self.batch_size)
        self.run.mark('batches')
        return model, opt['beta1']

    def _step(self, b, corrupted):
        return self.step(self.state, b['tokens'], b['chain'], self.run.seed, corrupted=corrupted)

    def work(self, units):
        B, cfg = self.batch_size, self.run.cfg
        hl, ll = int(self.tables['heavy_len']), int(self.tables['light_len'])
        calls = Y.bytenet_calls(cfg, self.kind, B, hl, ll)
        att = Y.attention_calls(cfg, B)
        return {'model_flops': units * Y.model_flops(cfg, self.kind, B, hl, ll, backward=True),
                'f32_flops': 0.0, 'bytenet_fwd': calls * units, 'bytenet_bwd': calls * units,
                'attention_fwd': att * units, 'attention_bwd': att * units}

    def _reference(self, mm):
        batches = [{'tokens': b['tokens'], 'cond': (b['region'], b['chain']), 'mask': b['mask'],
                    'drop': b['drop']} for b in self.checked]
        opt = dict(self.train['optimizer'], clip_norm=self.train['clip_norm'])
        return RT.run_steps(R.logits_fn(self.kind, int(self.tables['heavy_len'])), self.params,
                            self.run.cfg, batches, torch.as_tensor(self.cdr_row, device=self.dev),
                            int(self.tables['idx_msk']), opt, mm=mm)
