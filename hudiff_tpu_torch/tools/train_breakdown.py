"""Roofline the pretrain step: where a step's time goes, on the card.

Counterpart of tools/train_breakdown.py, on CUDA events and torch.profiler;
the JAX tool's ``HUDIFF_TB_*`` environment variables are flags here.

    python -m hudiff_tpu_torch.tools.train_breakdown [--nano] [--sweep 128,256,512]
        [--parts-batch 128] [--reps 6] [--sections sweep,parts,stages,profile]
    python -m hudiff_tpu_torch.tools.train_breakdown --device cpu --test-size \\
        --sweep 2 --parts-batch 2 --reps 1     # a smoke run on the CPU

prints one JSON object (progress goes to stderr). Random weights (torch
seed 0) at the full width of the default ``DenoiserConfig``
(configs/antibody_train.yml) or, with ``--nano``, ``nano_config()``
(configs/heavy_train.yml); bf16 compute over f32 parameters, as the
pretrain CLI trains; ``--test-size`` takes the configs' test widths.

1. ``step_sweep``: the full step (``train_step.make_pair_train_step`` or
   ``make_heavy_train_step``: corruption, forward, loss, backward, clip 10,
   Adam) at each batch: ms, GFLOP (``utils/flops.py``'s whole-model count
   of a forward and backward), TFLOP/s and MFU against the H100's bf16
   dense peak.
2. ``parts_B<b>`` at one batch: the forward in eval mode, in train mode
   (dropout on), forward + backward, forward + backward with the model's
   dropout 0 (the positional MLP's fixed p = 0.5 stays, as in JAX), and
   the full step; the dropout tax and the backward fall out by
   subtraction.
3. ``stages_B<b>``: each stage's forward against its forward + backward
   (aa towers, dual or nano_conv towers, the attention stack), to see which
   stage's backward runs furthest below its forward's rate.
4. ``profile_B<b>``: one warm full step under torch.profiler. On the card:
   the device ms by group as PERF.md §5 groups them (K1-K4 by kernel name,
   cuBLAS, and "other torch"), the idle share of the step's host window,
   and the top ops of the other group by device ms (each kernel counted
   under the op that launched it). On the CPU: the step's CPU ms by op
   group (matmul, other), the top other ops, and the time between ops
   (``unattributed_ms``): together the window.

Times are medians over ``--windows`` windows of ``--reps`` calls after a
warm-up: CUDA events on the card, the host clock on the CPU. The JAX tool's
fourth probe, threefry against rbg dropout keys, has no counterpart:
torch's dropout draws from one Philox generator. AbNatiV's group is not
reported: no scorer runs in a pretrain step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from .. import constants as C
from . import added_ms
from ..models.denoiser import (AntiTFNet, DenoiserConfig, NanoAntiTFNet, SelfAttNet,
                               SplitConvTowers, nano_config)
from ..ops import masking
from ..ops.bytenet import ByteNetStack
from ..ops.fused_attention import attention_matmul_flops
from ..training import schedules, train_step as T
from ..utils.config import Namespace
from ..utils.device import resolve_device
from ..utils.flops import (H100_SXM_BF16_DENSE_TFLOPS, denoiser_model_flops,
                           denoiser_stage_flops)

# device kernels by group, matched in this order (PERF.md §5's groups)
KERNEL_GROUPS = (('K4', ('bytenet_bwd_',)), ('K3', ('rope_attention_bwd_',)),
                 ('K1', ('rope_attention_qkv_kernel',)), ('K2', ('bytenet_fwd_gemm_kernel',)),
                 ('cublas', ('gemm', 'cutlass', 'nvjet', 'xmma')))
MATMUL_OPS = ('aten::mm', 'aten::addmm', 'aten::bmm', 'aten::baddbmm', 'aten::matmul',
              'aten::linear', 'aten::einsum', 'aten::convolution', 'aten::_convolution',
              'aten::mkldnn_convolution', 'aten::conv1d')
MARK = 'breakdown_window'


def sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int = 6, windows: int = 3) -> float:
    """Median ms a call over ``windows`` windows of ``reps`` calls, after a
    warm-up call: CUDA events on a card, the host clock on the CPU."""
    fn()
    sync(device)
    cuda = torch.device(device).type == 'cuda'
    out = []
    for _ in range(windows):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(out)


def rate_row(ms: float, flops: float, device) -> dict:
    """ms, GFLOP, TFLOP/s and, on a card, the share of the H100's bf16
    dense peak."""
    row = {'ms': ms, 'gflops': flops / 1e9, 'tflops_per_sec': flops / ms / 1e9}
    if torch.device(device).type == 'cuda':
        row['mfu_pct'] = 100 * row['tflops_per_sec'] / H100_SXM_BF16_DENSE_TFLOPS
    return row


def kernel_group(name: str) -> str:
    key = name.lower()
    return next((g for g, subs in KERNEL_GROUPS if any(s in key for s in subs)), 'other')


def _descendants(event):
    for child in event.cpu_children:
        yield child
        yield from _descendants(child)


def profile_window(fn, device, top: int = 15) -> dict:
    """One call of ``fn`` under torch.profiler, after a call that warms the
    profiler (which can drop the first records it sees): on a card the
    device ms by kernel group over the call's host window and the top ops
    of the other group; on the CPU the call's op time by group and the
    time between ops, which sum to the window."""
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = torch.device(device).type == 'cuda'

    def settle():
        sync(device)
        if cuda:   # the profiler's device and host clocks may lie apart
            time.sleep(0.05)

    fn()
    settle()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        fn()
        settle()
        t0 = time.perf_counter()
        with record_function(MARK):
            fn()
            sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        settle()
    events = prof.events()
    mark = next(e for e in events if e.name == MARK)
    if not cuda:
        by_group = {'matmul': 0.0, 'other': 0.0}
        other = {}
        for e in _descendants(mark):
            ms = e.self_cpu_time_total / 1e3
            group = 'matmul' if e.name in MATMUL_OPS else 'other'
            by_group[group] += ms
            if group == 'other':
                other[e.name] = other.get(e.name, 0.0) + ms
        return {'window_ms': mark.cpu_time_total / 1e3, 'host_wall_ms': wall_ms,
                'cpu_ms_by_group': by_group,
                'unattributed_ms': mark.self_cpu_time_total / 1e3,
                'other_top_ops': [{'op': k, 'cpu_ms': v} for k, v in sorted(
                    other.items(), key=lambda kv: kv[1], reverse=True)[:top]]}
    start = mark.time_range.start
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, 'is_user_annotation', False) and e.time_range.start > start]
    by_group = dict.fromkeys(('K1', 'K2', 'K3', 'K4', 'cublas', 'other'), 0.0)
    counts = dict.fromkeys(by_group, 0)
    for e, ms in zip(kernels, added_ms(kernels)):   # what each adds to the busy time
        by_group[kernel_group(e.name)] += ms
        counts[kernel_group(e.name)] += 1
    other = {}
    for e in events:   # each kernel under the op that launched it
        if e.device_type == torch.autograd.DeviceType.CPU and e.time_range.start > start:
            for k in e.kernels:
                if kernel_group(k.name) == 'other':
                    ms, n = other.get(e.name, (0.0, 0))
                    other[e.name] = (ms + k.duration / 1e3, n + 1)
    busy = sum(by_group.values())
    return {'window_ms': wall_ms, 'device_busy_ms': busy, 'device_idle_share': 1 - busy / wall_ms,
            'kernels': len(kernels), 'kernels_by_group': counts, 'device_ms_by_group': by_group,
            'other_unattributed_ms': by_group['other'] - sum(v[0] for v in other.values()),
            'other_top_ops': [{'op': k, 'device_ms': v[0], 'kernels': v[1]} for k, v in sorted(
                other.items(), key=lambda kv: kv[1][0], reverse=True)[:top]]}


def model_config(nano: bool, test_size: bool) -> DenoiserConfig:
    cfg = nano_config() if nano else DenoiserConfig()
    return cfg.test_size() if test_size else cfg


def build(cfg: DenoiserConfig, nano: bool, B: int, device, dtype=torch.bfloat16):
    """(model in train mode, tokens, chain or None) at batch B, random weights
    from torch seed 0 and tokens from numpy seed 0."""
    torch.manual_seed(0)
    model = (NanoAntiTFNet if nano else AntiTFNet)(cfg, dtype=dtype, device=device).train()
    rs = np.random.RandomState(0)
    L = C.HEAVY_LEN if nano else C.PAIR_LEN
    tokens = torch.as_tensor(rs.randint(0, C.N_AA, (B, L)), device=device)
    chain = None if nano else torch.as_tensor(np.tile([[0, 2]], (B, 1)), device=device)
    return model, tokens, chain


def step_fn(model, nano: bool, tokens, chain):
    """A full train step on the fixed grids: Adam (lr 1e-4), clip 10."""
    opt = schedules.make_optimizer(Namespace({'type': 'Adam', 'lr': 1e-4}), model.parameters())
    state = T.TrainState(model, opt, clip_norm=10.0)
    step = T.make_heavy_train_step(model) if nano else T.make_pair_train_step(model)
    if nano:
        return lambda: step(state, tokens, 1)
    return lambda: step(state, tokens, chain, 1)


def bench_full_step(cfg, nano, B, args) -> dict:
    model, tokens, chain = build(cfg, nano, B, args.device)
    ms = time_ms(step_fn(model, nano, tokens, chain), args.device, args.reps, args.windows)
    kind = 'heavy' if nano else 'pair'
    row = rate_row(ms, denoiser_model_flops(cfg, B, kind=kind, backward=True), args.device)
    row['steps_per_sec'] = 1e3 / ms
    return row


def bench_parts(cfg, nano, B, args) -> dict:
    """Forward / forward + backward / dropout decomposition at one batch."""
    kind = 'heavy' if nano else 'pair'
    model, tokens, chain = build(cfg, nano, B, args.device)
    nodrop = type(model)(dataclasses.replace(cfg, dropout=0.0), dtype=model.dtype,
                         device=args.device).train()
    nodrop.load_state_dict(model.state_dict())
    L = tokens.shape[1]
    cdr = torch.as_tensor(C.HEAVY_CDR_INDEX if nano else np.concatenate(
        [C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX]), device=args.device) != 0
    cdr = cdr.expand(B, L)
    cor = masking.corrupt(T.generator(args.device, 3), tokens, cdr)
    region = torch.as_tensor(T.heavy_region_batch(B) if nano else T.pair_region_batch(B),
                             device=args.device)
    cond = (region,) if nano else (region, chain)

    def loss(mod):
        logits = mod(cor.src, *cond)
        if nano:
            return T._heavy_loss(logits, tokens, cor.mask, cdr)['loss']
        return T._pair_loss(logits, tokens, cor.mask, cdr, 'merge', 1.0)['loss']

    def forward(mod, train):
        def fn():
            mod.train(train)
            with torch.no_grad():
                return loss(mod)
        return fn

    def fwd_bwd(mod):
        def fn():
            mod.train()
            mod.zero_grad(set_to_none=True)
            loss(mod).backward()
        return fn

    fwd, both = (denoiser_model_flops(cfg, B, kind=kind, backward=b) for b in (False, True))
    out = {}
    for tag, fn, flops in (('fwd_eval', forward(model, False), fwd),
                           ('fwd_train', forward(model, True), fwd),
                           ('fwd_bwd_train', fwd_bwd(model), both),
                           ('fwd_bwd_nodrop', fwd_bwd(nodrop), both),
                           ('step', step_fn(model, nano, tokens, chain), both)):
        out[tag] = rate_row(time_ms(fn, args.device, args.reps, args.windows), flops,
                            args.device)
    return out


def bench_stages(cfg, nano, B, args) -> dict:
    """Each stage's forward against its forward + backward (train mode,
    the parameters' gradients; the input needs none)."""
    dev, dtype = args.device, torch.bfloat16
    kind = 'heavy' if nano else 'pair'
    L = C.HEAVY_LEN if nano else C.PAIR_LEN
    flops = denoiser_stage_flops(cfg, B, kind=kind)
    torch.manual_seed(1)
    K, r = cfg.aa_kernel_size, cfg.r
    if nano:
        aa = ByteNetStack(cfg.n_encoder_layers, cfg.d_model, K, r, activation=cfg.activation,
                          dropout=cfg.dropout, device=dev)
        dual = ByteNetStack(cfg.dual_layers, cfg.sum_d_model, K, r, activation='gelu',
                            dropout=cfg.dropout, device=dev)
    else:
        aa = SplitConvTowers(cfg.n_encoder_layers, cfg.d_model, K, r, cfg.activation,
                             cfg.dropout, device=dev)
        dual = SplitConvTowers(cfg.dual_layers, cfg.sum_d_model, K, r, 'relu', cfg.dropout,
                               device=dev)
    att = SelfAttNet(cfg.sum_d_model, cfg.att_model, cfg.dim_feedforward, cfg.nhead,
                     cfg.max_len, cfg.cs_layers, dtype=dtype, device=dev)
    att_bwd = 3 * flops['self_att'] + 2 * cfg.cs_layers * attention_matmul_flops(
        B, L, cfg.nhead, cfg.att_model // cfg.nhead, backward=True)
    out = {}
    for name, mod, d, f_fwd, f_both in (
            ('aa_towers', aa, cfg.d_model, flops['aa_towers'], 3 * flops['aa_towers']),
            ('dual_towers', dual, cfg.sum_d_model, flops['dual_towers'],
             3 * flops['dual_towers']),
            ('self_att', att, cfg.sum_d_model, flops['self_att'] + flops['attention_core'],
             att_bwd)):
        mod.train()
        x = torch.randn(B, L, d, device=dev).to(dtype)

        def fwd(mod=mod, x=x):
            with torch.no_grad():
                return mod(x)

        def both(mod=mod, x=x):
            mod.zero_grad(set_to_none=True)
            mod(x).float().sum().backward()

        out[f'{name}_fwd'] = rate_row(time_ms(fwd, dev, args.reps, args.windows), f_fwd, dev)
        out[f'{name}_fwd_bwd'] = rate_row(time_ms(both, dev, args.reps, args.windows),
                                          f_both, dev)
    return out


def profile_step(cfg, nano, B, args) -> dict:
    model, tokens, chain = build(cfg, nano, B, args.device)
    return profile_window(step_fn(model, nano, tokens, chain), args.device)


def _batches(text: str):
    return [int(b) for b in text.split(',') if b]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    p.add_argument('--nano', action='store_true', help='HuDiff-Nb (nano_config) instead of Ab')
    p.add_argument('--test-size', action='store_true', help="the configs' test widths")
    p.add_argument('--sweep', default='128,256,512', help='batches of the full-step sweep')
    p.add_argument('--parts-batch', type=int, default=128,
                   help='batch of the parts, stages and profile sections')
    p.add_argument('--reps', type=int, default=6, help='calls a timed window')
    p.add_argument('--windows', type=int, default=3, help='timed windows (the median kept)')
    p.add_argument('--sections', default='sweep,parts,stages,profile')
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    args.device = dev
    cfg = model_config(args.nano, args.test_size)
    sections = args.sections.split(',')
    B = args.parts_batch
    result = {'device': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
              'stack': 'nano' if args.nano else 'pair', 'test_size': args.test_size,
              'bf16_peak_tflops': H100_SXM_BF16_DENSE_TFLOPS, 'reps': args.reps,
              'windows': args.windows}
    for name, key, fn in (('sweep', 'step_sweep', None),
                          ('parts', f'parts_B{B}', bench_parts),
                          ('stages', f'stages_B{B}', bench_stages),
                          ('profile', f'profile_B{B}', profile_step)):
        if name not in sections:
            continue
        if fn is None:
            result[key] = {str(b): bench_full_step(cfg, args.nano, b, args)
                           for b in _batches(args.sweep)}
        else:
            result[key] = fn(cfg, args.nano, B, args)
        print(f'{name}: {json.dumps(result[key])}', file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
