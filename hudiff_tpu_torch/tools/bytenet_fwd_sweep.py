"""K2's forward designs timed against each other on the card, launch by launch.

    python -m hudiff_tpu_torch.tools.bytenet_fwd_sweep [--shapes paths|main]
        [--tuning]

prints one JSON line per shape, then a summary line. For each shape the
paths give K2 (``--shapes paths``: the Ab towers 768/384 ReLU and 256/128
GELU at B = 1, 16, 32, 64 and 128, L = 152 and 139; the Nb towers 512/256
and 256/128 GELU at B = 1, 16, 64, 128 and 512, L = 152; ``main``: B = 16
and 128 on the Ab towers, B = 512 on the Nb towers), at dilation 1 and 32
(the conv's rows past the chain are zeroed at 32), it runs the bf16
forward on every design that takes the shape (``bytenet_block_plan``'s
'wgmma', 'wgmma128' and 'mma_sync'), holds each against the plain version
(|err| <= 2**-7 |ref| + 2.5e-2, the K2 limit) and checks that a repeat
gives the same bits, and times each as device ms a call
(``device_ms_<path>``: ``n`` calls captured in one CUDA graph, replayed,
the median over five replays), each of its three launches
(``launch_ms_<path>``: the median over five profiled calls), and on the
host clock a call of 20 eager calls in a row (``eager_ms_<path>``).
Beside them: the design the plan takes, ``fastest``, the Hopper designs'
resident clusters a launch (``clusters_<path>``) and the PyTorch
composition on the same inputs (``library_device_ms``: F.layer_norm, the
activation, F.linear, F.conv1d, F.linear; the yardstick, which the port
never calls). With ``--tuning``, the 64-row design with 64- and
128-column tiles on every launch (``device_ms_wgmma_bn64``, ``_bn128``),
the 128-row one with 128- and 256-column tiles on every launch
(``device_ms_wgmma128_bn128``, ``_bn256``, where N allows) and both
Hopper designs without the programmatic launch of F2 and F3
(``device_ms_<path>_nopdl``); a variant whose plan was timed already is
not timed again. Inputs are N(0, 1) and the block's own initialisation
from torch seed 0, bf16. The summary lists the
shapes where the plan's design is not the fastest. Needs a card; exits 2
without one. ``time_designs`` is the timing itself, which chip_smoke.py's
K2 records also take.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import fused_bytenet as FB
from .attention_bwd_sweep import graph_ms
from .bytenet_bwd_sweep import block_params, eager_ms, launch_ms

AB, NB = ((768, 'relu'), (256, 'gelu')), ((512, 'gelu'), (256, 'gelu'))
PATH_SHAPES = list(dict.fromkeys(   # the Nb 256/128 tower is the Ab one at L = 152
    [(B, L, D, act) for B in (1, 16, 32, 64, 128) for L in (152, 139) for D, act in AB]
    + [(B, 152, D, act) for B in (1, 16, 64, 128, 512) for D, act in NB]))
MAIN_SHAPES = ([(B, 152, D, act) for B in (16, 128) for D, act in AB]
               + [(512, 152, D, act) for D, act in NB])
DILATIONS = (1, 32)
K = 7
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 2.5e-2
DESIGNS = FB.K2_PATHS[:3]   # the bf16 designs: 'wgmma', 'wgmma128', 'mma_sync'
# other choices of the Hopper designs, timed with --tuning: (name, path, bn, pdl)
TUNING = (('wgmma_bn64', 'wgmma', 64, None), ('wgmma_bn128', 'wgmma', 128, None),
          ('wgmma128_bn128', 'wgmma128', 128, None),
          ('wgmma128_bn256', 'wgmma128', 256, None),
          ('wgmma_nopdl', 'wgmma', None, False), ('wgmma128_nopdl', 'wgmma128', None, False))


def excess(out, ref) -> float:
    """max(|out - ref| - 2**-7 |ref|): the K2 limit's measure."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() - BF16_RTOL * ref.abs()).max().item()


def composition_params(params, dtype):
    """The block's parameters for ``block_composition``: all in ``dtype``,
    the conv weight as F.conv1d takes it ([out, in, K])."""
    g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2 = (t.detach().to(dtype) for t in params)
    return g1, b1, w1, c1, g2, b2, wc.permute(0, 2, 1).contiguous(), cc, g3, b3, w2, c2


def block_composition(x, prm, dil, act):
    """The ByteNet block as PyTorch's own calls (F.layer_norm with eps 1e-6,
    the activation, F.linear, F.conv1d, F.linear): the yardstick K2 and,
    through autograd, K4 are timed beside. The port never calls it."""
    g1, b1, w1, c1, g2, b2, wconv, cc, g3, b3, w2, c2 = prm
    f = F.relu if act == 'relu' else F.gelu
    d, h, k = x.shape[-1], w1.shape[0], wconv.shape[-1]
    p = F.linear(f(F.layer_norm(x, (d,), g1, b1, 1e-6)), w1, c1)
    bb = f(F.layer_norm(p, (h,), g2, b2, 1e-6))
    q = F.conv1d(bb.transpose(1, 2), wconv, cc, padding=(k - 1) // 2 * dil,
                 dilation=dil).transpose(1, 2)
    return x + F.linear(f(F.layer_norm(q, (h,), g3, b3, 1e-6)), w2, c2)


def time_designs(call, held, shape, launches: bool = False, tuning: bool = False,
                 composition=None) -> dict:
    """Each design that takes ``shape`` (B, L, D, H, K, dilation) in bf16,
    held and then timed: ``call(plan)`` runs the forward and returns y,
    ``held(name, y)`` holds it to the K2 limit (it raises where y is off);
    a repeat must give the same bits (else RuntimeError). Returns ``path``
    (the plan's), ``device_ms`` (its design's), ``device_ms_<name>`` and,
    with ``launches``, ``launch_ms_<path>`` and ``eager_ms_<path>`` of each
    design; with ``tuning`` the TUNING variants' device ms (where a
    variant's plan is not one timed already); with ``composition`` (a
    callable) its device ms, ``library_device_ms``."""
    B, L, D, H, k, dil = shape
    bf = torch.bfloat16
    rec = {'path': FB.bytenet_block_plan(B, L, D, H, k, dil, bf)['path']}
    variants = [(path, path, None, None) for path in DESIGNS] + list(TUNING if tuning else ())
    timed = set()
    for name, path, bn, pdl in variants:
        try:
            plan = FB.bytenet_block_plan(B, L, D, H, k, dil, bf, path=path, bn=bn, pdl=pdl)
        except ValueError:   # the design does not take this shape
            continue
        key = (path, plan.get('array'))
        if key in timed:      # a variant whose plan was timed already
            continue
        timed.add(key)
        y, again = call(plan), call(plan)
        torch.cuda.synchronize()
        held(name, y)
        if not torch.equal(y, again):
            raise RuntimeError(f'K2 ({name}) repeats apart at B={B} L={L} D={D} dilation={dil}')
        del y, again
        rec[f'device_ms_{name}'] = graph_ms(lambda: call(plan))
        if launches and name == path:
            rec[f'launch_ms_{path}'] = launch_ms(lambda: call(plan), counter='launches',
                                                 match='bytenet_fwd_gemm_kernel')
            rec[f'eager_ms_{path}'] = eager_ms(lambda: call(plan))
    rec['device_ms'] = rec[f"device_ms_{rec['path']}"]
    if composition is not None:
        rec['library_device_ms'] = graph_ms(composition)
    return rec


def measure(B: int, L: int, D: int, act: str, dil: int, tuning: bool, gen) -> dict:
    """One shape: every design held and timed (see the module's doc)."""
    dev, bf = torch.device('cuda'), torch.bfloat16
    H = D // 2
    params = [t.to(bf) if t.dim() >= 2 else t
              for t in block_params(D, act, dil, dev, gen)]   # as the sampler holds them
    x = torch.randn(B, L, D, generator=gen).to(dev, bf)
    kw = dict(dilation=dil, activation_name=act)
    ref = FB.bytenet_block_reference(x, *params, **kw)
    rec = {'B': B, 'L': L, 'D': D, 'H': H, 'act': act, 'dil': dil}

    def held(name, y):
        rec[f'excess_{name}'] = excess(y, ref)
        if rec[f'excess_{name}'] > BF16_ATOL or not bool(torch.isfinite(y).all()):
            raise RuntimeError(f'K2 ({name}) off its plain version at B={B} L={L} D={D} '
                               f'dilation={dil}: excess {rec[f"excess_{name}"]}')

    lib = composition_params(params, bf)
    rec.update(time_designs(
        lambda plan: FB._forward(x, params, dil, act, keep=False, plan=plan)[0], held,
        (B, L, D, H, K, dil), launches=True, tuning=tuning,
        composition=lambda: block_composition(x, lib, dil, act)))
    times = {p: rec[f'device_ms_{p}'] for p in DESIGNS if f'device_ms_{p}' in rec}
    rec['fastest'] = min(times, key=times.get)
    for path in FB.K2_HOPPER:
        rec[f'clusters_{path}'] = FB.k2_occupancy(FB.bytenet_block_plan(B, L, D, H, K, dil, bf,
                                                                        path=path))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--shapes', choices=('paths', 'main'), default='paths')
    ap.add_argument('--tuning', action='store_true')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('bytenet_fwd_sweep: needs a card', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({'card': smi, 'torch': torch.__version__}), flush=True)
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    misses, failed = [], []
    for B, L, D, act in (PATH_SHAPES if args.shapes == 'paths' else MAIN_SHAPES):
        for dil in DILATIONS:
            try:
                rec = measure(B, L, D, act, dil, args.tuning, gen)
            except RuntimeError as e:
                failed.append([B, L, D, dil, str(e)[:300]])
                continue
            print(json.dumps(rec), flush=True)
            if rec['fastest'] != rec['path']:
                misses.append([B, L, D, dil, rec['path'], rec['device_ms'], rec['fastest'],
                               rec[f"device_ms_{rec['fastest']}"]])
            torch.cuda.empty_cache()
    print(json.dumps({'plan_not_fastest': misses, 'failed': failed}), flush=True)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
