"""Fine-tuning steps of the nanobody denoiser against two frozen AbNatiV
scorers (VH and VHH), as ``configs/nano_finetune.yml`` sets them.

Traffic parameters (``traffic/<mix>.json``): ``batch``, ``pool`` (batches
made at set-up from the seed and cycled: synthetic nanobodies of
``residues`` residues, each on its IMGT grid and its AHo grid, with an
OA-ARDM corruption over the first 150 slots that spares the CDRs and empty
slots, and the Gumbel uniforms of the step) and ``warm_steps``. The
batches are made ahead because a Python generator would pace the step.
The optimizer, clip and loss are the configuration's ``finetune`` section,
the compute type its ``dtype``.

Set-up builds the infilling denoiser (train mode, at the configuration's
dropout: ``_steps.py`` says how the reference follows the masks) and two
frozen scorers at the released hparams with random weights from the seed,
the loss (``models.finetune.make_nano_finetune_loss``), the step
(``training.finetune.make_nano_finetune_fns``) and one training state, and
drives them through their first three steps, the checked ones, through the
window's call; then ``warm_steps`` more. A unit is one step on the next
batch of the pool, its corruption and uniforms handed in.

The check, once the window has closed: the reference
(``reference/finetune.py``) follows the three steps from the same weights,
batches, corruption, uniforms and dropout masks, and at the masked slots
that reach the scorers from the program's straight-through choices, which
a hook reads off the VH scorer's input in each checked step. Another hook
reads the denoiser's logits of the first checked step: ``logits_gap`` is
their distance from the reference's, as a share of the reference's norm.
A choice of the program is read by its gap below the reference's best
perturbed logit (``st_gap_max``), as a served token is.
"""
from __future__ import annotations

import math

import torch

from benchmark import generate as G
from benchmark import weights
from benchmark import yardstick as Y
from benchmark.drivers._steps import StepDriver
from benchmark.reference import finetune as RF

from hudiff_tpu_torch.models import abnativ as AB
from hudiff_tpu_torch.models import finetune as FT
from hudiff_tpu_torch.models.denoiser import DenoiserConfig, NanoAntiTFNet
from hudiff_tpu_torch.training import finetune as FTT
from hudiff_tpu_torch.training import schedules
from hudiff_tpu_torch.training import train_step as T
from hudiff_tpu_torch.utils.config import Namespace

class ChoiceReader:
    """A hook on the VH scorer that keeps the straight-through choice it
    read in the step (each AHo slot's token, [B, 149]); ``read(batch)``
    hands it to the batch as ``follow``, -1 on rows the step did not score."""

    def __init__(self, scorer):
        self.last = None
        self.handle = scorer.register_forward_pre_hook(self._hook)

    def _hook(self, module, args):
        self.last = args[0].detach().argmax(-1).cpu()

    def read(self, batch: dict) -> None:
        f, rows = self.last, len(batch['tokens'])
        batch['follow'] = torch.cat([f, f.new_full((rows - len(f),) + f.shape[1:], -1)])
        self.last = None

    def remove(self):
        self.handle.remove()


class LogitsReader:
    """A hook on the denoiser that keeps its residues' logits of the first
    checked step (``read(batch)``: the batch's ``logits``, NaN on rows the
    step did not compute)."""

    def __init__(self, model, n_aa: int):
        self.last, self.n_aa = None, n_aa
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, module, args, out):
        self.last = out[..., :self.n_aa].detach().float().cpu()

    def read(self, batch: dict) -> None:
        if self.last is not None:
            f, rows = self.last, len(batch['tokens'])
            batch['logits'] = torch.cat([f, f.new_full((rows - len(f),) + f.shape[1:], math.nan)])
            self.last = None
            self.handle.remove()

    def remove(self):
        self.handle.remove()


class Driver(StepDriver):
    kind = 'heavy'

    def _batches(self, rng, B):
        t, c = self.tables, self.consts
        L = int(t['heavy_len'])
        tokens, aho = G.nano_finetune_rows(self.t['pool'] * B, c['nano_imgt_candidates'],
                                           c['nano_aho_candidates'], tuple(self.t['residues']),
                                           int(t['idx_pad']), c['gap_idx'], rng)
        masks = G.oardm_masks(self.t['pool'], B, L, t['heavy_cdr_index'] != 0, rng,
                              window=c['nano_imgt_candidates'])
        masks &= tokens.reshape(self.t['pool'], B, L) != int(t['idx_pad'])
        gen = torch.Generator(device=self.dev).manual_seed(int(rng.integers(2 ** 62)))
        region = torch.as_tensor(t['heavy_region_index'], device=self.dev).expand(B, L)
        pool = []
        for k in range(self.t['pool']):
            tok = torch.as_tensor(tokens[k * B:(k + 1) * B], dtype=torch.long, device=self.dev)
            a = torch.as_tensor(aho[k * B:(k + 1) * B], dtype=torch.long, device=self.dev)
            pool.append({'tokens': tok, 'region': region,
                         'aho': torch.nn.functional.one_hot(a, c['alphabet_size']).float(),
                         'mask': torch.as_tensor(masks[k], device=self.dev),
                         'u': torch.rand((B, L, c['gap_idx']), generator=gen, device=self.dev)})
        return pool

    def _build(self):
        rng = G.seed_sequence(self.run.seed, 1)
        self.ft, self.consts = self.run.cfg['finetune'], G.load_data('abnativ')
        cfg = DenoiserConfig.from_dict(self.run.cfg)
        model = NanoAntiTFNet(cfg, dtype=getattr(torch, self.run.cfg['dtype']), device=self.dev)
        self.params = weights.make([(k, tuple(v.shape)) for k, v in model.state_dict().items()],
                                   self.run.seed, self.dev)
        model.load_state_dict(self.params)
        hp = AB.AbNatiVParams.from_dict(self.consts['hparams'])
        self.scorer_params, scorers = {}, []
        for i, name in enumerate(('vh', 'vhh')):
            scorer = AB.AbNatiVModel(hp, straight_through=False).to(self.dev)
            p = weights.make([(k, tuple(v.shape)) for k, v in scorer.state_dict().items()],
                             self.run.seed + 1 + i, self.dev)
            scorer.load_state_dict(p)
            self.scorer_params[name] = p
            scorers.append(AB.frozen(scorer))
        self.vh_scorer, self.model = scorers[0], model
        self.run.mark('models')
        loss = FT.make_nano_finetune_loss(model, scorers[0], FT.NanoFinetuneConfig(), scorers[1])
        self.step, _ = FTT.make_nano_finetune_fns(loss, reconstruct=False,
                                                  recon_weight=self.ft['reconstruct_loss_weight'])
        opt = self.ft['optimizer']
        self.state = T.TrainState(model, schedules.make_optimizer(Namespace(opt),
                                                                 model.parameters()),
                                  clip_norm=self.ft['clip_norm'])
        self.batch_size = self.ft['batch_size']
        self.pool = self._batches(rng, self.batch_size)
        self.run.mark('batches')
        return model, opt['beta1']

    def _step(self, b, corrupted):
        return self.step(self.state, b['tokens'], b['aho'], self.run.seed, corrupted=corrupted,
                         u=b['u'])

    def work(self, units):
        B, cfg, hl = self.batch_size, self.run.cfg, int(self.tables['heavy_len'])
        calls = Y.bytenet_calls(cfg, self.kind, B, hl, 0)
        att = Y.attention_calls(cfg, B)
        # three scorer forwards a step, and the input gradients of two
        scorer = 5 * Y.abnativ_flops(self.consts['hparams'], B)
        return {'model_flops': units * Y.model_flops(cfg, self.kind, B, hl, 0, backward=True),
                'f32_flops': units * scorer, 'bytenet_fwd': calls * units,
                'bytenet_bwd': calls * units, 'attention_fwd': att * units,
                'attention_bwd': att * units}

    def _readers(self):
        return [ChoiceReader(self.vh_scorer), LogitsReader(self.model, self.consts['gap_idx'])]

    def _choice_numbers(self, chose, c_chose=None):
        want = chose[0]['logits']
        if c_chose is None:
            return {'logits_gap': RF.logits_gap(self.checked[0]['logits'], want),
                    'st_gap_max': max(c['gap'] for c in chose)}
        return {'logits_gap': RF.logits_gap(c_chose[0]['logits'], want),
                'st_gap_max': RF.choice_gap(chose, [c['choice'] for c in c_chose])}

    def _reference(self, mm):
        t = self.tables
        opt = dict(self.ft['optimizer'], clip_norm=self.ft['clip_norm'])
        return RF.run_steps(self.params, self.run.cfg, self.consts['hparams'], self.scorer_params,
                            self.consts, self.checked,
                            torch.as_tensor(t['heavy_cdr_index'], device=self.dev),
                            int(t['idx_msk']), int(t['idx_pad']), opt, mm=mm)
