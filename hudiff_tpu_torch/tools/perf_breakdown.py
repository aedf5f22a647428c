"""Stage-by-stage timing of the HuDiff-Ab forward: where a forward's time
goes, on the card.

Counterpart of tools/perf_breakdown.py, on CUDA events and torch.profiler.

    python -m hudiff_tpu_torch.tools.perf_breakdown [--batch 64] [--reps 32]
    python -m hudiff_tpu_torch.tools.perf_breakdown --device cpu --test-size --batch 2 --reps 1

prints one JSON object (progress goes to stderr): the full bf16 forward of
``AntiTFNet`` (eval mode, random weights from torch seed 0, the default
``DenoiserConfig``: configs/antibody_train.yml) and each stage alone, the
aa towers, the dual towers, the attention stack and the embedders; for each
its ms, GFLOP (``utils/flops.py``'s matmul count of the stage), TFLOP/s and
its share of the H100's bf16 dense peak. A stage alone misses what it shares
with its neighbours, so the stages' sum may exceed the full forward. The
full forward is also profiled once (``train_breakdown.profile_window``):
device ms by kernel group and the top ops of the other group.

Times are medians over ``--windows`` windows of ``--reps`` calls after a
warm-up: CUDA events on the card (each call on the same inputs; the card
caches nothing between calls), the host clock on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import constants as C
from ..models.denoiser import AntiTFNet, SelfAttNet, SplitConvTowers
from ..models.embedders import PosEmbedder, RegionEmbedder, SideEmbedder
from ..training import train_step as T
from ..utils.device import resolve_device
from ..utils.flops import H100_SXM_BF16_DENSE_TFLOPS, denoiser_stage_flops
from .train_breakdown import model_config, profile_window, rate_row, time_ms


def stages(cfg, B: int, device, dtype=torch.bfloat16):
    """{stage: (call, FLOPs)} for one forward of B rows, eval mode."""
    torch.manual_seed(0)
    rs = np.random.RandomState(0)
    tokens = torch.as_tensor(rs.randint(0, C.N_AA, (B, C.PAIR_LEN)), device=device)
    region = torch.as_tensor(T.pair_region_batch(B), device=device)
    chain = torch.as_tensor(np.tile([[0, 2]], (B, 1)), device=device)
    flops = denoiser_stage_flops(cfg, B, kind='pair')
    K, r = cfg.aa_kernel_size, cfg.r
    kw = dict(device=device)
    model = AntiTFNet(cfg, dtype=dtype, **kw).eval()
    aa = SplitConvTowers(cfg.n_encoder_layers, cfg.d_model, K, r, cfg.activation,
                         cfg.dropout, **kw).eval()
    dual = SplitConvTowers(cfg.dual_layers, cfg.sum_d_model, K, r, 'relu', cfg.dropout,
                           **kw).eval()
    att = SelfAttNet(cfg.sum_d_model, cfg.att_model, cfg.dim_feedforward, cfg.nhead,
                     cfg.max_len, cfg.cs_layers, dtype=dtype, **kw).eval()
    side = SideEmbedder(cfg.n_side, cfg.s_embedding, cfg.s_model, C.HEAVY_LEN, C.LIGHT_LEN,
                        dtype=dtype, **kw).eval()
    reg = RegionEmbedder(cfg.n_region, cfg.r_embedding, cfg.r_model, dtype=dtype, **kw).eval()
    pos = PosEmbedder(cfg.n_pos_model, cfg.max_len, dtype=dtype, **kw).eval()
    x_emb = torch.randn(B, C.PAIR_LEN, cfg.d_model, device=device).to(dtype)
    x_sum = torch.randn(B, C.PAIR_LEN, cfg.sum_d_model, device=device).to(dtype)
    return {
        'full_forward': (lambda: model(tokens, region, chain),
                         sum(flops.values())),
        'aa_conv_towers': (lambda: aa(x_emb), flops['aa_towers']),
        'dual_conv_towers': (lambda: dual(x_sum), flops['dual_towers']),
        'self_att_stack': (lambda: att(x_sum), flops['self_att'] + flops['attention_core']),
        'embedders': (lambda: pos(reg(region)) + side(chain), flops['embedders']),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    p.add_argument('--batch', type=int, default=64)
    p.add_argument('--test-size', action='store_true', help="the config's test widths")
    p.add_argument('--reps', type=int, default=32, help='calls a timed window')
    p.add_argument('--windows', type=int, default=3, help='timed windows (the median kept)')
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = model_config(False, args.test_size)
    rows = {}
    with torch.inference_mode():
        calls = stages(cfg, args.batch, dev)
        for name, (fn, flops) in calls.items():
            rows[name] = rate_row(time_ms(fn, dev, args.reps, args.windows), flops, dev)
            print(f'{name}: {json.dumps(rows[name])}', file=sys.stderr, flush=True)
        profile = profile_window(calls['full_forward'][0], dev)
    result = {'device': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu',
              'batch': args.batch, 'test_size': args.test_size, 'reps': args.reps,
              'windows': args.windows, 'bf16_peak_tflops': H100_SXM_BF16_DENSE_TFLOPS,
              'stages': rows,
              'stage_sum_ms': sum(v['ms'] for k, v in rows.items() if k != 'full_forward'),
              'profile_full_forward': profile}
    print(json.dumps(result), flush=True)
    return result


if __name__ == '__main__':
    main()
