"""Pretraining CLI for HuDiff-Ab (paired) and HuDiff-Nb (heavy-only), in
PyTorch.

Counterpart of hudiff_tpu/training/pretrain.py. The step (OA-ARDM
corruption, forward, loss, backward, update) runs on the card through the
port's kernels (training/train_step.py); the host keeps the plateau LR
scheduler, full-split validation, best-val checkpoints and JSONL metrics,
with the JAX CLI's iteration semantics: one iteration is ``batch_acc``
optimizer steps, ``max_iter`` and ``valid_step`` count iterations, logged
train metrics are window means, and a resume continues at
``opt_steps // batch_acc`` with the scheduler's state. ``--resume`` takes
the port's run directories and the JAX package's Orbax ones (optax's Adam
moments mapped onto the port's Adam through the parameters' name map).

Usage:
  # synthetic smoke run (no data needed), on the CPU:
  python -m hudiff_tpu_torch.training.pretrain --config configs/antibody_test.yml \\
      --synthetic 64 --max-iter 3 --device cpu
  # full width on the card (the default device):
  python -m hudiff_tpu_torch.training.pretrain --config configs/antibody_train.yml \\
      --synthetic 1024 --max-iter 10
  # the nanobody model (--kind heavy, inferred from the config's name):
  python -m hudiff_tpu_torch.training.pretrain --config configs/heavy_train.yml \\
      --synthetic 1024 --max-iter 10
  # real data (data/oas.py): an OAS root holding processed/oas_pair_tmp (or
  # new_cgz_data/ to build it from), or a heavy-chain pickle for --kind heavy
  python -m hudiff_tpu_torch.training.pretrain --config configs/antibody_train.yml \\
      --data /path/to/oas_pair_root
  python -m hudiff_tpu_torch.training.pretrain --config configs/heavy_train.yml \\
      --data /path/to/heavy.pkl

Parallel runs (parallel/mesh.py), one process per card under torchrun:
  # data parallel over the 8 cards of a node, or dp 4 x tp 2 (--tp splits
  # each attention by head group and the FFN by unit):
  torchrun --nproc_per_node 8 -m hudiff_tpu_torch.training.pretrain \
      --config configs/antibody_train.yml --synthetic 4096 [--tp 2]
  # several nodes (each node's torchrun with --nnodes, --node_rank and the
  # rendezvous address):
  torchrun --nnodes 2 --node_rank 0 --nproc_per_node 8 --rdzv_endpoint HOST:PORT \
      -m hudiff_tpu_torch.training.pretrain --config ... --multihost

A launch with WORLD_SIZE > 1 (or ``--multihost``, which requires the
launcher's environment) starts the process group: NCCL on the card, gloo
with ``--device cpu``. The batch follows the JAX package's per-process
rule (hudiff_tpu/training/pretrain.py:105, data/pipeline.py:47-65), a
host being a node: each node draws ``batch_size`` rows from seed ``seed +
1000 * node_rank``, its DP ranks split them, the ranks of a TP group keep
the same rows; so one node trains on what one process trains on, and the
global batch is ``batch_size`` x nodes. Dropout draws from torch's
generator seeded by DP rank, so a TP group's replicated towers draw one
mask. The validation metrics are the gathered global batch's, equal on
every rank. Rank 0 writes the run directory, its metrics and the
checkpoints, gathered to the tp = 1 layout (a resume re-shards to any
``--tp``); other ranks log under ``<run dir>/rank_<r>/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from .. import constants as C
from ..data import oas, pipeline
from ..models.denoiser import DenoiserConfig, nano_config
from ..parallel import mesh as M
from ..tokenizer import Tokenizer
from ..utils import tracing
from ..utils.config import Namespace, load_yaml
from ..utils.device import resolve_device
from . import checkpoints, schedules, train_step as T
from .logger import (MetricsWriter, count_parameters, get_logger, get_new_log_dir,
                     seed_all, snapshot_source)

def synthetic_batches(kind: str, batch_size: int, seed: int = 0
                      ) -> Iterator[Dict[str, np.ndarray]]:
    """Random human-like grids for smoke testing without OAS data."""
    rs = np.random.RandomState(seed)
    L = C.PAIR_LEN if kind == 'pair' else C.HEAVY_LEN
    while True:
        tokens = rs.randint(0, C.N_AA, (batch_size, L)).astype(np.int32)
        batch = {'tokens': tokens}
        if kind == 'pair':
            batch['chain_type'] = np.stack(
                [np.zeros(batch_size, np.int32),
                 rs.choice([1, 2], batch_size).astype(np.int32)], axis=1)
        yield batch


def data_batches(kind: str, data_path: str, batch_size: int, split: str,
                 seed: int = 0):
    """(iterator, n_batches_per_epoch) over a dataset split: an
    ``OasPairDataset`` root for the pair kind, an ``OasUnpairDataset``
    heavy pickle for the heavy one (hudiff_tpu/training/pretrain.py:
    56-70). The val iterator is unshuffled, so pulling n_batches per
    validation walks the whole split once."""
    tok = Tokenizer()
    if kind == 'pair':
        ds = oas.OasPairDataset(data_path)

        def collate(recs):
            return oas.pair_batch(recs, tok)
    else:
        ds = oas.OasUnpairDataset(data_path, chaintype='heavy')

        def collate(recs):
            return oas.heavy_batch(recs, tok)
    it = oas.batch_iterator(ds, ds.splits[split], batch_size, collate, seed=seed,
                            shuffle=(split == 'train'))
    return it, oas.n_batches_per_epoch(len(ds.splits[split]), batch_size)


def model_config(cfg: Namespace, kind: str) -> DenoiserConfig:
    """``cfg.model`` over the kind's defaults (``nano_config`` for heavy)."""
    base = dataclasses.asdict(nano_config()) if kind == 'heavy' else {}
    return DenoiserConfig.from_dict({**base, **dict(cfg.model)})


def build_model(kind: str, model_cfg: DenoiserConfig, dtype, device,
                mesh: Optional[M.Mesh] = None) -> torch.nn.Module:
    """A new model of ``kind`` drawn from torch's generator as it stands:
    under a mesh of tp > 1 every rank draws the tp = 1 weights and keeps its
    shard, so that the ranks of one seed hold that seed's tp = 1 model."""
    model_cls = checkpoints.model_class(kind)
    model = model_cls(model_cfg, dtype=dtype, device=device)
    if mesh is None or mesh.tp == 1:
        return model
    full = model.state_dict()
    model = model_cls(model_cfg, dtype=dtype, device=device, tp_mesh=mesh)
    model.load_state_dict(M.shard_state_dict(full, mesh))
    return model


def seed_dropout(seed: int, mesh: Optional[M.Mesh]) -> None:
    """Seed dropout's generator (torch's) by DP rank: one stream a DP rank,
    so that the replicated towers of a TP group draw one mask."""
    torch.manual_seed(seed + (mesh.dp_rank if mesh is not None else 0))


def run(cfg: Namespace, kind: str = 'pair', data_path: Optional[str] = None,
        logdir: str = './logs', synthetic: int = 0, max_iter: Optional[int] = None,
        valid_step: Optional[int] = None, resume: Optional[str] = None,
        seed: Optional[int] = None, use_bf16: bool = True, tag: str = '',
        device='cuda', model: Optional[torch.nn.Module] = None, tp: int = 1) -> str:
    """Pretrain ``AntiTFNet`` (``kind='pair'``) or ``NanoAntiTFNet``
    (``'heavy'``) and return the run directory. ``model``, when given, is
    trained in place (it must match ``cfg.model`` and ``kind`` and lie on
    ``device``; not with ``tp`` > 1); otherwise one is built from
    ``cfg.model`` after seeding torch. In a started process group (parallel/
    mesh.py) every rank calls this: the world is laid out as dp x ``tp``."""
    model_cls = checkpoints.model_class(kind)
    if not synthetic and not data_path:
        raise ValueError('pretrain.run needs synthetic > 0 or a data_path')
    mesh = M.make_mesh(model_axis=tp) if M.world_size() > 1 or tp > 1 else None
    if mesh is not None and mesh.tp > 1 and model is not None:
        raise ValueError('pretrain.run builds the model under --tp > 1; pass model=None')
    dev = M.rank_device(device) if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    node = 0 if mesh is None else mesh.node_rank
    seed = seed if seed is not None else cfg.train.get('seed', 2023)
    seed_all(seed)
    torch.manual_seed(seed)

    log_dir = M.broadcast_object(
        get_new_log_dir(logdir, prefix=f'{kind}_pretrain', tag=tag) if lead else None, mesh)
    own_dir = log_dir if lead else os.path.join(log_dir, f'rank_{mesh.rank}')
    os.makedirs(own_dir, exist_ok=True)
    logger = get_logger('pretrain', own_dir)
    metrics_writer = MetricsWriter(own_dir)
    if lead:
        snapshot_source(log_dir)

    model_cfg = model_config(cfg, kind)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    if model is None:
        model = build_model(kind, model_cfg, dtype, dev, mesh)
    elif not isinstance(model, model_cls):
        raise ValueError(f'--kind {kind} trains a {model_cls.__name__}, '
                         f'not a {type(model).__name__}')
    if mesh is not None:
        seed_dropout(seed, mesh)
        logger.info('rank %d of %d: dp %d x tp %d, node %d of %d, %s', mesh.rank, mesh.world,
                    mesh.dp, mesh.tp, mesh.node_rank, mesh.nodes, dev)
    logger.info('parameters: %d', count_parameters(model))

    batch_size = cfg.train.batch_size
    max_iter = max_iter if max_iter is not None else cfg.train.max_iter
    valid_step = valid_step if valid_step is not None else cfg.train.valid_step
    batch_acc = cfg.train.get('batch_acc', 1)

    # each node draws its own batch (JAX's per-process seed); its DP ranks
    # split it in the step
    data_seed = seed + 1000 * node
    if synthetic:
        train_it = synthetic_batches(kind, batch_size, data_seed)
        val_it = synthetic_batches(kind, batch_size, data_seed + 1)
        # synthetic data has no finite val split; use a small fixed pass
        n_val_batches = max(1, min(4, synthetic // batch_size))
    else:
        train_it, _ = data_batches(kind, data_path, batch_size, 'train', data_seed)
        val_it, n_val_batches = data_batches(kind, data_path, batch_size, 'val', data_seed + 1)
    train_feed = pipeline.device_feed(train_it, dev)
    val_feed = pipeline.device_feed(val_it, dev)

    optimizer = schedules.make_optimizer(cfg.train.optimizer, model.parameters())
    state = T.TrainState(model, optimizer, clip_norm=cfg.train.get('clip_norm'), mesh=mesh)
    plateau = schedules.make_host_scheduler(cfg.train.scheduler,
                                            init_lr=cfg.train.optimizer.lr)

    best_val = float('inf')
    if resume:
        restored = checkpoints.restore(resume)
        if restored['kind'] != kind:
            raise ValueError(f"{resume} holds a {restored['kind']!r} model, not {kind!r}")
        shards = mesh or M.Mesh()
        model.load_state_dict(M.shard_state_dict(restored['payload']['model'], shards))
        opt_sd = checkpoints.optimizer_state(restored['payload'], model, optimizer)
        optimizer.load_state_dict(M.shard_optimizer_state(opt_sd, model, shards))
        # checkpoints are labeled by iteration; state.step counts optimizer
        # steps (batch_acc per iteration)
        meta = restored['meta']
        state.step = int(meta.get('opt_steps', restored['step']))
        if meta.get('scheduler'):
            plateau.load_state_dict(meta['scheduler'])
            schedules.set_learning_rate(optimizer, plateau.lr)
        if meta.get('val_loss') is not None:
            best_val = float(meta['val_loss'])
        logger.info('resumed from %s at step %d (lr %.3g, best val %.5f)',
                    resume, restored['step'], plateau.lr, best_val)

    loss_type = cfg.train.get('loss_type', 'merge')
    l_weight = cfg.train.get('l_loss_weight', 1.0)
    pair = kind == 'pair'
    if pair:
        pair_step = T.make_pair_train_step(model, loss_type=loss_type, l_weight=l_weight,
                                           mesh=mesh)

        def step_fn(state, batch, seed):
            return pair_step(state, batch['tokens'], batch['chain_type'], seed)
    else:
        heavy_step = T.make_heavy_train_step(model, mesh=mesh)

        def step_fn(state, batch, seed):
            return heavy_step(state, batch['tokens'], seed)
    eval_fn = T.make_eval_step(model, loss_type=loss_type, l_weight=l_weight, pair=pair,
                               mesh=mesh)

    ckpt_dir = os.path.join(log_dir, 'checkpoints')
    if lead:
        os.makedirs(ckpt_dir, exist_ok=True)
    corrupt_seed = seed + 17 + 1000 * node
    config = {'model': dataclasses.asdict(model_cfg), 'kind': kind,
              'train': cfg.train.to_dict() if hasattr(cfg.train, 'to_dict')
              else dict(cfg.train)}

    start_it = state.step // batch_acc
    t_start = time.time()
    it = start_it
    model.train()
    while it < max_iter:
        # one iteration = batch_acc optimizer steps; the logged train
        # metrics are the window's means
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(batch_acc):
            batch = next(train_feed)
            m = step_fn(state, batch, corrupt_seed)
            for k, v in m.items():
                sums[k] = sums[k] + v if k in sums else v
        it += 1
        m = {k: float(v) / batch_acc for k, v in sums.items()}
        m['lr'] = schedules.get_learning_rate(optimizer) or 0.0
        m['opt_steps'] = float(state.step)
        m['steps_per_sec'] = ((it - start_it) * batch_acc
                              / max(time.time() - t_start, 1e-9))
        metrics_writer.write(it, m, prefix='train')
        logger.info('iter %d | %s', it,
                    ' | '.join(f'{k}: {v:.5f}' for k, v in sorted(m.items())))

        if it % max(valid_step, 1) == 0 or it >= max_iter:
            # full-split validation: average over every val batch
            def _val_step(vbatch, j, _it=it):
                return eval_fn(vbatch['tokens'], vbatch.get('chain_type'),
                               T.generator(dev, seed + 1000 * node, _it, j))

            vm = T.evaluate(_val_step, val_feed, n_val_batches)
            metrics_writer.write(it, vm, prefix='val')
            logger.info('valid %d | %s', it,
                        ' | '.join(f'{k}: {v:.5f}' for k, v in sorted(vm.items())))
            new_lr = plateau.update(vm['loss'])
            schedules.set_learning_rate(optimizer, new_lr)
            if vm['loss'] < best_val:
                best_val = vm['loss']
                shards = mesh or M.Mesh()   # the gathers are collectives: every rank
                full = (M.gather_state_dict(model.state_dict(), shards),
                        M.gather_optimizer_state(optimizer.state_dict(), model, shards))
                if lead:
                    checkpoints.save_training(ckpt_dir, it, model, optimizer, config=config,
                                              extra={'val_loss': best_val,
                                                     'opt_steps': state.step,
                                                     'scheduler': plateau.state_dict()},
                                              state=full)
                    logger.info('saved best checkpoint at iter %d (val %.5f)', it, best_val)
                del full
    metrics_writer.close()
    return log_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--config', required=True)
    p.add_argument('--kind', choices=['pair', 'heavy'], default=None,
                   help='inferred from config name if omitted')
    p.add_argument('--data', default=None)
    p.add_argument('--logdir', default='./logs')
    p.add_argument('--synthetic', type=int, default=0,
                   help='use N synthetic samples instead of real data')
    p.add_argument('--max-iter', type=int, default=None)
    p.add_argument('--valid-step', type=int, default=None)
    p.add_argument('--resume', default=None)
    p.add_argument('--seed', type=int, default=None)
    p.add_argument('--fp32', action='store_true')
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    p.add_argument('--profile', action='store_true',
                   help="trace the run with torch.profiler into <logdir>/profile/trace.json "
                        "and write the port's own spans beside it (spans.json: each step's "
                        'host and device time, garbage collections; utils/tracing.py)')
    p.add_argument('--tp', type=int, default=1,
                   help='tensor-parallel size: each attention split by head group, the '
                        'FFN by unit, over tp contiguous ranks (the world must divide by it)')
    p.add_argument('--multihost', action='store_true',
                   help="start the process group from torchrun's environment (required "
                        'here); a launch with WORLD_SIZE > 1 starts it anyway')
    p.add_argument('--tag', default='')
    args = p.parse_args(argv)

    cfg = load_yaml(args.config)
    kind = args.kind or ('heavy' if 'heavy' in os.path.basename(args.config)
                         or cfg.get('name') == 'nano' else 'pair')
    if not args.synthetic and not args.data:
        p.error('need --synthetic N or --data PATH')
    if args.tp < 1:
        p.error('--tp must be at least 1')
    launched = int(os.environ.get('WORLD_SIZE', '1')) > 1
    if args.multihost and not all(k in os.environ for k in ('RANK', 'WORLD_SIZE',
                                                             'MASTER_ADDR')):
        # without a launcher the rendezvous would wait forever: fail fast
        p.error('--multihost: multi-node parallelism needs a launcher environment (torchrun '
                'sets RANK, WORLD_SIZE and MASTER_ADDR); none detected')
    started = (args.multihost or launched) and not torch.distributed.is_initialized()
    if started:
        M.init_distributed(device=args.device)
    if M.world_size() % args.tp:
        p.error(f'--tp {args.tp}: tensor parallelism needs a world divisible by {args.tp}, '
                f'not {M.world_size()} rank(s); launch tp x dp processes under torchrun')
    kw = dict(synthetic=args.synthetic, max_iter=args.max_iter, valid_step=args.valid_step,
              resume=args.resume, seed=args.seed, use_bf16=not args.fp32, tag=args.tag,
              device=args.device, tp=args.tp)
    try:
        return _main_run(args, cfg, kind, kw)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _main_run(args, cfg, kind, kw):
    """``run`` under the CLI's profiler flag (one trace a rank)."""
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.device(args.device).type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        trace_dir = os.path.join(args.logdir, 'profile')
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            out = run(cfg, kind, args.data, args.logdir, **kw)
        rank = '' if M.world_size() == 1 else f'_rank{torch.distributed.get_rank()}'
        prof.export_chrome_trace(os.path.join(trace_dir, f'trace{rank}.json'))
        with open(os.path.join(trace_dir, f'spans{rank}.json'), 'w') as f:
            json.dump(tracing.records(), f)
        print(f'profiler trace and spans written to {trace_dir}')
        return out
    return run(cfg, kind, args.data, args.logdir, **kw)


if __name__ == '__main__':
    main()
