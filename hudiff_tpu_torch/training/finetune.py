"""Fine-tuning CLIs: AbNatiV-guided humanness optimization, in PyTorch.

Counterpart of hudiff_tpu/training/finetune.py (the reference's
antibody_scripts/antibody_finetune.py and nanobody_scripts/nanofinetune.py):

- Ab: loss = humanness (VH + VL scorers) + H_cdr_ce + L_cdr_ce
        + mouse_ratio * (H_ce + L_ce)           (antibody_finetune.py:71)
- Nb: loss = humanness (VH) [+ delta-VHH] + cdr_ce
        [+ recon_weight * reconstruct_ce]       (nanofinetune.py:120-146)
  with optional cross-training: a human-heavy OA-ARDM step every
  ``cross_interval`` iterations (nanofinetune.py:76-97).

Only the infilling denoiser learns; the AbNatiV scorers are frozen f32
modules on the same device. The denoiser computes in bf16 over f32
parameters unless ``--fp32``; on the card its forward and backward run
through K1-K4 as in pretraining. A step draws its corruption and its
Gumbel uniforms, in that order, from a ``torch.Generator`` seeded from
``(seed, state.step)``; a caller may hand both in instead (the parity
tests inject the JAX step's). Dropout follows the model's mode: the loop
trains in ``train()``, as the JAX step runs with ``deterministic=False``,
and the eval step, like the JAX one, computes the step's loss (dropout and
Gumbel noise included) without an update. Gradients are clipped to
``clip_norm`` on the Nb path only (configs/nano_finetune.yml), as the JAX
CLI does. Each step is one device span ``step`` (``utils.tracing``).
Each validation drives the plateau LR; the best one saves a checkpoint
with ``finetuned: True`` and its ``kind``, which ``humanize ab|nano
--ckpt`` loads.

Usage:
  python -m hudiff_tpu_torch.training.finetune nano --config configs/nano_finetune.yml \\
      --pretrain-ckpt NB.pt --abnativ-vh vh.ckpt --abnativ-vhh vhh.ckpt --synthetic
  python -m hudiff_tpu_torch.training.finetune ab --config configs/antibody_finetune.yml \\
      --pretrain-ckpt AB.pt --abnativ-vh vh.ckpt --abnativ-vlk vk.ckpt \\
      --abnativ-vll vl.ckpt --mouse-data OAS_ROOT
  (add --device cpu to run on the CPU; without a scorer file a scorer is
  random-initialized at small smoke hparams)
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import constants as C
from ..data import oas, pipeline
from ..models import abnativ as AB
from ..models import finetune as FT
from ..ops import losses, masking
from ..sampling.humanize import load_denoiser
from ..tokenizer import Tokenizer
from ..utils import tracing
from ..utils.config import Namespace, load_yaml
from ..utils.device import resolve_device
from . import checkpoints as CKPT
from . import schedules, train_step as T
from .logger import MetricsWriter, get_logger, get_new_log_dir, seed_all, snapshot_source

# the random-init scorer's hparams when no checkpoint is given (smoke runs)
SMOKE_ABNATIV = AB.AbNatiVParams(d_embedding=32, kernel=4, stride=2, num_heads=2,
                                 num_mha_layers=1, d_ff=64, num_embeddings=16,
                                 embedding_dim_code_book=8)


# ---------------------------------------------------------------------------
# AbNatiV loading
# ---------------------------------------------------------------------------

def load_abnativ(path: Optional[str], straight_through: bool, seed: int = 0,
                 device='cuda') -> AB.AbNatiVModel:
    """A frozen f32 scorer on ``device``: from a reference-layout checkpoint
    (``{'state_dict', 'hyper_parameters': {'hparams': ...}}``: the released
    lightning ``.ckpt`` files, whose hparams may be pickled objects, read
    through ``CKPT.load_payload``, or a file ``save_abnativ`` wrote) when
    ``path`` is given, else random-initialized from ``seed`` at the smoke
    hparams. A path that does not exist raises (the JAX loader falls back
    to a random scorer)."""
    dev = resolve_device(device)
    if path:
        ckpt = CKPT.load_payload(path)
        model = AB.AbNatiVModel(AB.checkpoint_hparams(ckpt), straight_through)
        model.load_state_dict(AB.reference_state_dict(ckpt['state_dict'], model))
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = AB.AbNatiVModel(SMOKE_ABNATIV, straight_through)
    return AB.frozen(model.to(dev))


def save_abnativ(path: str, model: AB.AbNatiVModel) -> str:
    """Write ``model`` as a reference-layout checkpoint (the layout
    ``load_abnativ`` and the JAX package's ``convert_torch_abnativ`` read)."""
    torch.save({'state_dict': {k: v.detach().cpu() for k, v in model.state_dict().items()},
                'hyper_parameters': {'hparams': dataclasses.asdict(model.hp)}}, path)
    return path


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

@tracing.span('step', device=True)
def _apply(state: T.TrainState, total_loss, gen, args, corrupted, u):
    loss, metrics = total_loss(*args, gen, corrupted, u)
    loss.backward()
    state.apply_gradients()
    return {k: v.detach() for k, v in metrics.items()}


def _evaluate(total_loss, gen, args):
    with torch.no_grad():
        return total_loss(*args, gen, None, None)[1]


def _uniforms(gen, u, shape, device):
    return u if u is not None else torch.rand(shape, generator=gen, device=device)


def make_nano_finetune_fns(loss_fn: FT.LossFn, reconstruct: bool, recon_weight: float):
    """``(step, eval_step)`` of the Nb framework:

    - ``step(state, tokens, aho, seed, corrupted=None, u=None) -> metrics``:
      one optimizer step on clean grids ``tokens`` [B, 152] with their AHo
      one-hots ``aho`` [B, 149, 21];
    - ``eval_step(tokens, aho, generator) -> metrics``: the same loss, no
      update (reference finetune_val, nanofinetune.py:202-335).

    The loss is the framework's humanness loss + the CDR CE (+ the
    reconstruct term); the framework is corrupted over the first 150 slots
    (the camel collater's window), CDRs and grid pads protected.
    """
    rows = {}

    def total_loss(tokens, aho, gen, corrupted, u):
        dev = tokens.device
        if dev not in rows:
            rows[dev] = T._heavy_rows(dev)
        cdr_row, region_row = rows[dev]
        B, L = tokens.shape
        cdr_mask = (cdr_row != 0).expand(B, L)
        cor = corrupted if corrupted is not None else masking.corrupt(
            gen, tokens, cdr_mask | (tokens == C.IDX_PAD), window=150)
        batch = {'src': cor.src, 'mask': cor.mask, 'ref': tokens,
                 'region': region_row.expand(B, L), 'aho': aho}
        ab_loss, (metrics, logits) = loss_fn(batch, _uniforms(gen, u, (B, L, C.N_AA), dev))
        ce = losses.nano_finetune_ce(logits, tokens, cdr_mask, mask=cor.mask,
                                     reconstruct=reconstruct)
        loss = ab_loss + ce['cdr_ce']
        metrics['cdr_ce'] = ce['cdr_ce']
        if reconstruct:
            loss = loss + recon_weight * ce['reconstruct_ce']
            metrics['reconstruct_ce'] = ce['reconstruct_ce']
        metrics['loss'] = loss
        return loss, metrics

    def step(state, tokens, aho, seed, corrupted=None, u=None):
        return _apply(state, total_loss, T.generator(tokens.device, seed, state.step),
                      (tokens, aho), corrupted, u)

    def eval_step(tokens, aho, gen):
        return _evaluate(total_loss, gen, (tokens, aho))

    return step, eval_step


def make_ab_finetune_fns(loss_fn: FT.LossFn, mouse_h_ratio: float, mouse_l_ratio: float):
    """``(step, eval_step)`` of the Ab framework (loss composition:
    antibody_finetune.py:71):

    - ``step(state, tokens, chain_type, aho, seed, corrupted=None, u=None)
      -> metrics`` on clean grids ``tokens`` [B, 291], ``chain_type`` [B, 2]
      and ``aho`` [B, 298, 21] (heavy then light AHo one-hots);
    - ``eval_step(tokens, chain_type, aho, generator) -> metrics``.

    The corruption protects the Kabat CDRs without the vernier zone and the
    grid pads (mouse mode); the CE terms read the plain CDRs.
    """
    rows = {}

    def total_loss(tokens, chain_type, aho, gen, corrupted, u):
        dev = tokens.device
        if dev not in rows:
            rows[dev] = (T._pair_rows(dev, mouse=True)[0], *T._pair_rows(dev))
        cdr_row, plain_cdr, region_row = rows[dev]
        B, L = tokens.shape
        cor = corrupted if corrupted is not None else masking.corrupt(
            gen, tokens, masking.pair_protected_mask(tokens, cdr_row, protect_pads=True))
        batch = {'src': cor.src, 'mask': cor.mask, 'ref': tokens,
                 'region': region_row.expand(B, L), 'chain_type': chain_type, 'aho': aho}
        ab_loss, (metrics, logits) = loss_fn(batch, _uniforms(gen, u, (B, L, C.N_AA), dev))
        ce = losses.pair_oardm_split_loss(logits, tokens, cor.mask,
                                          (plain_cdr != 0).expand(B, L))
        loss = (ab_loss + ce['h_cdr_ce'] + ce['l_cdr_ce']
                + mouse_h_ratio * ce['h_ce'] + mouse_l_ratio * ce['l_ce'])
        metrics.update({k: ce[k] for k in ('h_cdr_ce', 'l_cdr_ce', 'h_ce', 'l_ce')})
        metrics['loss'] = loss
        return loss, metrics

    def step(state, tokens, chain_type, aho, seed, corrupted=None, u=None):
        return _apply(state, total_loss, T.generator(tokens.device, seed, state.step),
                      (tokens, chain_type, aho), corrupted, u)

    def eval_step(tokens, chain_type, aho, gen):
        return _evaluate(total_loss, gen, (tokens, chain_type, aho))

    return step, eval_step


# ---------------------------------------------------------------------------
# Synthetic consistent batches (copied from hudiff_tpu/training/finetune.py:
# 165-210; the same numpy draws)
# ---------------------------------------------------------------------------

def synthetic_nano_batches(batch_size: int, seed: int = 0
                           ) -> Iterator[Dict[str, np.ndarray]]:
    rs = np.random.RandomState(seed)
    while True:
        tokens = np.empty((batch_size, C.HEAVY_LEN), np.int32)
        aho = np.zeros((batch_size, C.AHO_LEN, C.ABNATIV_ALPHABET_SIZE), np.float32)
        for b in range(batch_size):
            n_res = rs.randint(110, 126)
            res = rs.randint(0, 20, n_res)
            grid = np.full(C.HEAVY_LEN, C.IDX_PAD, np.int32)
            slots = np.sort(rs.choice(150, n_res, replace=False))
            grid[slots] = res
            grid[150:] = rs.randint(0, 20, 2)
            tokens[b] = grid
            arow = np.full(C.AHO_LEN, C.ABNATIV_GAP_IDX, np.int32)
            aslots = np.sort(rs.choice(147, n_res, replace=False))
            arow[aslots] = res
            arow[147:] = grid[150:]
            aho[b, np.arange(C.AHO_LEN), arow] = 1.0
        yield {'tokens': tokens, 'aho': aho}


def synthetic_pair_batches(batch_size: int, seed: int = 0
                           ) -> Iterator[Dict[str, np.ndarray]]:
    rs = np.random.RandomState(seed)
    nano = synthetic_nano_batches(batch_size, seed)
    while True:
        h = next(nano)
        l = next(nano)
        l_tokens = np.array(l['tokens'][:, : C.LIGHT_LEN])
        # light grid: slot 138 is the single tail; AHo light tail = col 148
        # (col 147 must stay gap so the count invariants hold)
        l_tokens[:, 137] = C.IDX_PAD
        l_aho = np.array(l['aho'])
        l_aho[:, 147, :] = 0.0
        l_aho[:, 147, C.ABNATIV_GAP_IDX] = 1.0
        tokens = np.concatenate([h['tokens'], l_tokens], axis=1)
        chain = np.stack([np.zeros(batch_size, np.int32),
                          rs.choice([1, 2], batch_size).astype(np.int32)], 1)
        yield {'tokens': tokens, 'chain_type': chain,
               'aho': np.concatenate([h['aho'], l_aho], axis=1)}


def _synthetic_heavy_gen(batch_size: int, seed: int):
    rs = np.random.RandomState(seed)
    while True:
        yield {'tokens': rs.randint(0, C.N_AA, (batch_size, C.HEAVY_LEN)).astype(np.int32)}


# ---------------------------------------------------------------------------
# OAS heavy batches for cross-training (hudiff_tpu/training/finetune.py:376-402)
# ---------------------------------------------------------------------------

def _heavy_collate(recs):
    return {'tokens': oas.heavy_batch(recs, Tokenizer())['tokens']}


def oas_heavy_batches(path: str, batch_size: int, seed: int):
    ds = oas.OasUnpairDataset(path, chaintype='heavy')
    return oas.batch_iterator(ds, ds.splits['train'], batch_size, _heavy_collate, seed=seed)


def oas_heavy_val_batches(path: str, batch_size: int):
    """(iterator, n_batches) over the heavy val split."""
    ds = oas.OasUnpairDataset(path, chaintype='heavy')
    return (oas.batch_iterator(ds, ds.splits['val'], batch_size, _heavy_collate,
                               shuffle=False),
            oas.n_batches_per_epoch(len(ds.splits['val']), batch_size))


# ---------------------------------------------------------------------------
# Run loops
# ---------------------------------------------------------------------------

def _restore_finetune(resume_dir: str, state: T.TrainState, plateau, kind: str, logger):
    """Resume a fine-tune run: model, optimizer and step counter,
    host-scheduler state and best validation loss (the reference reloads
    the saved framework and scheduler, nanofinetune.py:530-539), from the
    port's run directory or the JAX package's Orbax one. Returns (the
    iteration to continue after, the best validation loss)."""
    restored = CKPT.restore(resume_dir)
    if restored['kind'] != kind:
        raise ValueError(f"{resume_dir} holds a {restored['kind']!r} model, not {kind!r}")
    state.model.load_state_dict(restored['payload']['model'])
    state.optimizer.load_state_dict(CKPT.optimizer_state(restored['payload'], state.model,
                                                         state.optimizer))
    meta = restored['meta']
    state.step = int(meta.get('opt_steps', restored['step']))
    best = float(meta.get('val_loss', float('inf')))
    if meta.get('scheduler'):
        plateau.load_state_dict(meta['scheduler'])
        schedules.set_learning_rate(state.optimizer, plateau.lr)
    logger.info('resumed from %s at iteration %d (lr %.3g, best val %.5f)',
                resume_dir, restored['step'], plateau.lr, best)
    return int(restored['step']), best


def _fmt(m: Dict[str, float]) -> str:
    return ' | '.join(f'{k}: {v:.5f}' for k, v in sorted(m.items()))


def _loop(cfg: Namespace, args, kind: str, state: T.TrainState, train_feed,
          step_batch, val_feed, n_val_batches: int, eval_batch, log_dir: str, logger,
          writer, seed: int, cross=None) -> None:
    """The iterations of a fine-tune run: a step a batch, the optional
    cross-training step, a full validation every ``valid_step``
    iterations driving the plateau LR and the best-val checkpoint.
    ``cross`` is ``(heavy_step_batch, heavy_val_metrics, interval)``."""
    model, optimizer = state.model, state.optimizer
    plateau = schedules.make_host_scheduler(cfg.finetune.scheduler,
                                            init_lr=cfg.finetune.optimizer.lr)
    ckpt_dir = os.path.join(log_dir, 'checkpoints')
    os.makedirs(ckpt_dir, exist_ok=True)
    best, start_it = float('inf'), 0
    if getattr(args, 'resume', None):
        start_it, best = _restore_finetune(args.resume, state, plateau, kind, logger)
    max_iter = args.max_iter or cfg.finetune.max_iter
    valid_step = args.valid_step or cfg.finetune.valid_step
    config = {'model': dataclasses.asdict(model.cfg), 'finetune': cfg.to_dict(),
              'finetuned': True, 'kind': kind}
    model.train()
    t0 = time.time()
    for it in range(start_it + 1, max_iter + 1):
        if cross is not None and it % cross[2] == 0:
            hm = cross[0](state)
            writer.write(it, {k: float(v) for k, v in hm.items()}, prefix='cross')
        m = {k: float(v) for k, v in step_batch(state, next(train_feed)).items()}
        m['steps_per_sec'] = (it - start_it) / max(time.time() - t0, 1e-9)
        writer.write(it, m, prefix='finetune')
        logger.info('iter %d | %s', it, _fmt(m))
        if it % valid_step == 0 or it == max_iter:
            # full held-out validation drives the plateau LR and the
            # best-checkpoint choice (reference nanofinetune.py:524-539)
            vm = T.evaluate(lambda vb, j, _it=it: eval_batch(
                vb, T.generator(vb['tokens'].device, seed, 7919 + _it, j)),
                val_feed, n_val_batches)
            if cross is not None:
                vm.update({f'heavy_{k}': v for k, v in cross[1](it).items()})
            writer.write(it, vm, prefix='val')
            logger.info('valid %d | %s', it, _fmt(vm))
            schedules.set_learning_rate(optimizer, plateau.update(vm['loss']))
            if vm['loss'] < best:
                best = vm['loss']
                CKPT.save_training(ckpt_dir, it, model, optimizer, config=config,
                                   extra={'val_loss': best, 'opt_steps': state.step,
                                          'scheduler': plateau.state_dict()})
                logger.info('saved best checkpoint at iter %d (val %.5f)', it, best)


def _setup(cfg: Namespace, args, prefix: str):
    seed = cfg.finetune.get('seed', 2023)
    seed_all(seed)
    torch.manual_seed(seed)
    log_dir = get_new_log_dir(args.logdir, prefix=prefix, tag=args.tag)
    snapshot_source(log_dir)
    return seed, log_dir, get_logger('finetune', log_dir), MetricsWriter(log_dir)


def run_nano(cfg: Namespace, args) -> str:
    """The Nb fine-tune (``finetune nano``); returns the run directory."""
    dev = resolve_device(args.device)
    seed, log_dir, logger, writer = _setup(cfg, args, 'nano_finetune')
    model, _ = load_denoiser(args.pretrain_ckpt, 'heavy', device=dev, use_bf16=not args.fp32)
    ft_cfg = FT.NanoFinetuneConfig(
        loss_type=cfg.model.loss_type, vhh_nativeness=cfg.model.vhh_nativeness,
        temperature=cfg.model.temperature, human_threshold=cfg.model.human_threshold,
        human_all_seq=cfg.model.human_all_seq, vhh_all_seq=cfg.model.vhh_all_seq,
        equal_weight=cfg.model.equal_weight)
    vh = load_abnativ(args.abnativ_vh, straight_through=False, seed=1, device=dev)
    vhh = (load_abnativ(args.abnativ_vhh, straight_through=False, seed=2, device=dev)
           if ft_cfg.vhh_nativeness else None)
    step_fn, eval_fn = make_nano_finetune_fns(
        FT.make_nano_finetune_loss(model, vh, ft_cfg, vhh),
        bool(cfg.model.get('part_reconstruct_vhh', False)),
        cfg.finetune.get('reconstruct_loss_weight', 1e-3))
    B = cfg.finetune.batch_size
    state = T.TrainState(model, schedules.make_optimizer(cfg.finetune.optimizer,
                                                         model.parameters()),
                         clip_norm=cfg.finetune.get('clip_norm'))

    cross = None
    if args.cross_training:
        heavy_step = T.make_heavy_train_step(model)
        heavy_eval = T.make_eval_step(model, pair=False)
        if args.heavy_data:
            heavy_it = oas_heavy_batches(args.heavy_data, B, seed)
            heavy_val_it, n_heavy_val = oas_heavy_val_batches(args.heavy_data, B)
        else:
            heavy_it = _synthetic_heavy_gen(B, seed)
            heavy_val_it, n_heavy_val = _synthetic_heavy_gen(B, seed + 500), 2
        heavy_feed = pipeline.device_feed(heavy_it, dev)
        heavy_val_feed = pipeline.device_feed(heavy_val_it, dev)

        def cross_step(state):
            return heavy_step(state, next(heavy_feed)['tokens'], seed)

        def cross_val(it):
            return T.evaluate(lambda vb, j: heavy_eval(
                vb['tokens'], None, T.generator(dev, seed, 104729 + it, j)),
                heavy_val_feed, n_heavy_val)

        cross = (cross_step, cross_val, cfg.finetune.get('cross_interval', 5))

    if args.synthetic:
        train_it = synthetic_nano_batches(B, seed)
        val_it, n_val = synthetic_nano_batches(B, seed + 501), 2
    else:
        ds = oas.OasUnpairDataset(args.vhh_data, chaintype='vhh')
        tok = Tokenizer()

        def collate(recs):
            return oas.heavy_batch(recs, tok, with_aho=True, drop_aho_failed=True)

        train_it = oas.batch_iterator(ds, ds.splits['train'], B, collate, seed=seed)
        # the held-out VHH split (reference vhh_val_loader, nanofinetune.py:416-435)
        val_it = oas.batch_iterator(ds, ds.splits['val'], B, collate, shuffle=False)
        n_val = oas.n_batches_per_epoch(len(ds.splits['val']), B)

    _loop(cfg, args, 'heavy', state, pipeline.device_feed(train_it, dev),
          lambda state, b: step_fn(state, b['tokens'], b['aho'], seed),
          pipeline.device_feed(val_it, dev), n_val,
          lambda b, gen: eval_fn(b['tokens'], b['aho'], gen),
          log_dir, logger, writer, seed, cross)
    writer.close()
    return log_dir


def run_ab(cfg: Namespace, args) -> str:
    """The Ab fine-tune (``finetune ab``); returns the run directory."""
    dev = resolve_device(args.device)
    seed, log_dir, logger, writer = _setup(cfg, args, 'ab_finetune')
    model, _ = load_denoiser(args.pretrain_ckpt, 'pair', device=dev, use_bf16=not args.fp32)
    # the reference leaves torch train-mode straight-through active on the
    # Ab path; the scorers keep it for the gradient
    vh, vlk, vll = (load_abnativ(p, straight_through=True, seed=s, device=dev) for p, s in
                    ((args.abnativ_vh, 1), (args.abnativ_vlk, 2), (args.abnativ_vll, 3)))
    ft_cfg = FT.AbFinetuneConfig(
        loss_type=cfg.model.loss_type, human_threshold=cfg.model.human_threshold,
        all_seq=cfg.model.all_seq, mutation=cfg.model.get('mutation', False))
    step_fn, eval_fn = make_ab_finetune_fns(
        FT.make_ab_finetune_loss(model, vh, vlk, vll, ft_cfg),
        cfg.model.get('mouse_resi_h_ratio', 0.0), cfg.model.get('mouse_resi_l_ratio', 0.0))
    B = cfg.finetune.batch_size
    state = T.TrainState(model, schedules.make_optimizer(cfg.finetune.optimizer,
                                                         model.parameters()))
    if args.synthetic:
        train_it = synthetic_pair_batches(B, seed)
        val_it, n_val = synthetic_pair_batches(B, seed + 501), 2
    else:
        ds = oas.OasPairDataset(args.mouse_data, mouse=True)
        tok = Tokenizer()

        def merge(recs):
            b = oas.pair_batch(recs, tok, with_aho=True)
            b['aho'] = np.concatenate([b.pop('aho_h'), b.pop('aho_l')], axis=1)
            return b

        train_it = oas.batch_iterator(ds, ds.splits['train'], B, merge, seed=seed)
        val_it = oas.batch_iterator(ds, ds.splits['val'], B, merge, shuffle=False)
        n_val = oas.n_batches_per_epoch(len(ds.splits['val']), B)

    _loop(cfg, args, 'pair', state, pipeline.device_feed(train_it, dev),
          lambda state, b: step_fn(state, b['tokens'], b['chain_type'], b['aho'], seed),
          pipeline.device_feed(val_it, dev), n_val,
          lambda b, gen: eval_fn(b['tokens'], b['chain_type'], b['aho'], gen),
          log_dir, logger, writer, seed)
    writer.close()
    return log_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest='cmd', required=True)
    for name in ('ab', 'nano'):
        q = sub.add_parser(name)
        q.add_argument('--config', required=True)
        q.add_argument('--pretrain-ckpt', required=True,
                       help="a port checkpoint of the kind ('pair' for ab, 'heavy' for nano)")
        q.add_argument('--abnativ-vh', default=None)
        q.add_argument('--logdir', default='./logs')
        q.add_argument('--synthetic', action='store_true')
        q.add_argument('--max-iter', type=int, default=None)
        q.add_argument('--valid-step', type=int, default=None)
        q.add_argument('--batch-size', type=int, default=None,
                       help='override the config batch size')
        q.add_argument('--resume', default=None,
                       help='checkpoint dir of a previous fine-tune run; restores '
                            'the model, optimizer, scheduler and best val loss')
        q.add_argument('--fp32', action='store_true')
        q.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
        q.add_argument('--tag', default='')
        if name == 'ab':
            q.add_argument('--abnativ-vlk', default=None)
            q.add_argument('--abnativ-vll', default=None)
            q.add_argument('--mouse-data', default=None)
        else:
            q.add_argument('--abnativ-vhh', default=None)
            q.add_argument('--vhh-data', default=None)
            q.add_argument('--heavy-data', default=None)
            q.add_argument('--cross-training', action='store_true')
    args = p.parse_args(argv)
    data = args.mouse_data if args.cmd == 'ab' else args.vhh_data
    if not args.synthetic and not data:
        p.error('need --synthetic or ' + ('--mouse-data' if args.cmd == 'ab' else '--vhh-data'))
    cfg = load_yaml(args.config)
    if args.batch_size:
        cfg.finetune.batch_size = args.batch_size
    if args.cmd == 'ab':
        return run_ab(cfg, args)
    return run_nano(cfg, args)


if __name__ == '__main__':
    main()
