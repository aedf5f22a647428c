"""K4's backward designs timed against each other on the card, launch by launch.

    python -m hudiff_tpu_torch.tools.bytenet_bwd_sweep [--shapes paths|main]
        [--splits]

prints one JSON line per shape, then a summary line. For each shape the
paths give K4 (``--shapes paths``: the Ab towers 768/384 ReLU and 256/128
GELU at B = 16, 32 and 128, L = 152 and 139; the Nb towers 512/256 and
256/128 GELU at B = 512, L = 152; ``main``: B = 128, L = 152 (Ab) and B =
512 (Nb)), at dilation 1 and 32 (the conv's taps past the chain are
zeroed at 32), it runs the backward given K2's LayerNorm statistics, as
autograd does, on every design that takes the shape
(``bytenet_block_backward_plan``'s 'wgmma' and 'mma_sync'), holds each
against the plain version given the same (bf16 dx: |err| <= 2**-7 |ref|
+ 1.5e-2; each parameter gradient: max |err| <= 2e-3 max |ref|, the card
tests' limits) and checks that a repeat gives the same bits, and times
each as device ms a call (``device_ms_<path>``: ``n`` calls captured in
one CUDA graph, replayed, the median over five replays) and each of its
five launches (``launch_ms_<path>``: three data GEMMs, the weight
gradients, the sum; the median over five profiled calls), and on the host
clock a call of 20 eager calls in a row (``eager_ms_<path>``: where the
device time is short, the host's work a call). Beside them:
the design the plan takes and ``fastest``, the Hopper design's resident
clusters and blocks (``occupancy``); with ``--splits``, the Hopper
design at other splits of the rows for the weight gradients
(``device_ms_by_splits``). Inputs are N(0, 1) and the block's own
initialisation from torch seed 0, bf16. The summary lists the shapes
where the plan's path is not the fastest. Needs a card; exits 2 without
one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from ..ops import fused_bytenet as FB
from ..ops.bytenet import ByteNetBlock
from . import added_ms
from .attention_bwd_sweep import graph_ms

AB, NB = ((768, 'relu'), (256, 'gelu')), ((512, 'gelu'), (256, 'gelu'))
PATH_SHAPES = ([(B, L, D, act) for B in (16, 32, 128) for L in (152, 139) for D, act in AB]
               + [(512, 152, D, act) for D, act in NB])
MAIN_SHAPES = [(128, 152, D, act) for D, act in AB] + [(512, 152, D, act) for D, act in NB]
DILATIONS = (1, 32)
K = 7
DX_RTOL, DX_ATOL, GRAD_RTOL = 2.0 ** -7, 1.5e-2, 2e-3
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def block_params(D: int, act: str, dil: int, dev, gen):
    """The 12 parameters of a ByteNetBlock (f32, as training holds them) with
    its own initialisation and the LayerNorms moved off 1 and 0."""
    blk = ByteNetBlock(D, D // 2, K, dilation=dil, activation=act)
    with torch.no_grad():
        for ln in (blk.ln1, blk.ln2, blk.ln3):
            ln.weight.add_(0.1 * torch.randn(ln.weight.shape, generator=gen))
            ln.bias.add_(0.1 * torch.randn(ln.bias.shape, generator=gen))
    return [t.detach().to(dev) for t in (blk.ln1.weight, blk.ln1.bias, blk.fc1.weight,
                                         blk.fc1.bias, blk.ln2.weight, blk.ln2.bias,
                                         blk.conv.weight, blk.conv.bias, blk.ln3.weight,
                                         blk.ln3.bias, blk.fc2.weight, blk.fc2.bias)]


def held(got, ref) -> dict:
    """dx's excess over 2**-7 |ref| and the largest gradient's max |err| /
    max |ref|, against the plain version, and whether both are within the
    limits and finite."""
    dx, dr = got[0].float(), ref[0].float()
    rec = {'dx_excess': ((dx - dr).abs() - DX_RTOL * dr.abs()).max().item(),
           'grad_rel_err': max(((a - b).abs().max() / b.abs().max()).item()
                               for a, b in zip(got[1:], ref[1:]))}
    rec['held'] = (rec['dx_excess'] <= DX_ATOL and rec['grad_rel_err'] <= GRAD_RTOL
                   and all(bool(torch.isfinite(t).all()) for t in got))
    return rec


def eager_ms(fn, n: int = 20, windows: int = 3) -> float:
    """Host-clock ms a call of ``n`` eager calls in a row ending in a
    synchronize, the median over ``windows``: where a call's device time is
    short, the wrapper's and the C entry's host work (tensor maps, launches)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / n)
    return statistics.median(out)


def launch_ms(fn, n: int = 5, counter: str = 'bwd_launches', match: str = 'bytenet_bwd'):
    """Device ms of each kernel one call of ``fn`` launches, in launch order:
    the median over ``n`` calls in one profiled run, a kernel charged from
    the later of its start and the previous kernel's end (``added_ms``);
    'not measured' where the profiler's records are not the calls' launches
    (``counter``: the wrapper's count, ``match`` in the kernels' names: K4's
    by default)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    before = getattr(FB, counter)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per = (getattr(FB, counter) - before) // n
    ks = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                 and match in e.name), key=lambda e: e.time_range.start)
    if len(ks) != per * n:
        return 'not measured'
    ms = added_ms(ks)
    return [statistics.median(ms[per * i + k] for i in range(n)) for k in range(per)]


def time_designs(call, ref, shape, splits: bool = False, launches: bool = True) -> dict:
    """Each design that takes ``shape`` (B, L, D, H, dilation) held against
    ``ref`` (a repeat must give the same bits; else RuntimeError), then
    timed: ``call(plan)`` runs the backward. Returns ``path`` (the plan's),
    ``device_ms`` (its design's), ``device_ms_<path>``, ``dx_excess_<path>``,
    ``grad_rel_err_<path>``, ``held_<path>``, with ``launches``
    ``launch_ms_<path>`` and ``eager_ms_<path>`` and, with ``splits``,
    ``device_ms_by_splits`` of the Hopper design."""
    B, L, D, H, dil = shape
    bf = torch.bfloat16
    plan = FB.bytenet_block_backward_plan(B, L, D, H, K, dil, bf)
    rec = {'path': plan['path']}
    for path in ('wgmma', 'mma_sync'):
        try:
            pl = FB.bytenet_block_backward_plan(B, L, D, H, K, dil, bf, path=path)
        except ValueError:   # the design does not take this shape
            continue
        got, again = call(pl), call(pl)
        torch.cuda.synchronize()
        check = held(got, ref)
        check['held'] = check['held'] and all(torch.equal(a, b) for a, b in zip(got, again))
        rec.update({f'{k}_{path}': v for k, v in check.items()})
        del got, again
        if not check['held']:
            raise RuntimeError(f'K4 ({path} design) disagrees with its plain version or '
                               f'repeats apart at B={B} L={L} D={D} dilation={dil}: {check}')
        rec[f'device_ms_{path}'] = graph_ms(lambda: call(pl))
        if launches:
            rec[f'launch_ms_{path}'] = launch_ms(lambda: call(pl))
            rec[f'eager_ms_{path}'] = eager_ms(lambda: call(pl))
        if path == 'wgmma' and splits:
            rec['device_ms_by_splits'] = {}
            for s in SPLITS:
                other = FB.bytenet_block_backward_plan(B, L, D, H, K, dil, bf, splits=s)
                key = other['wgrad']['splits']
                if key not in rec['device_ms_by_splits']:
                    rec['device_ms_by_splits'][key] = graph_ms(lambda: call(other))
    rec['device_ms'] = rec[f"device_ms_{rec['path']}"]
    return rec


def measure(B: int, L: int, D: int, act: str, dil: int, splits: bool, gen) -> dict:
    """One shape: every design held and timed (see the module's doc)."""
    dev, bf = torch.device('cuda'), torch.bfloat16
    H = D // 2
    params = block_params(D, act, dil, dev, gen)
    x = torch.randn(B, L, D, generator=gen).to(dev, bf)
    dy = torch.randn(B, L, D, generator=gen).to(dev, bf)
    kw = dict(dilation=dil, activation_name=act)
    _, p, q, st = FB._forward(x, params, dil, act, keep=True)
    cd = FB._prepared(params, dev, bf)   # the forward's copies, as autograd passes them
    ref = FB.bytenet_block_backward_reference(x, p, q, *params, dy, **kw, stats=st)
    rec = {'B': B, 'L': L, 'D': D, 'H': H, 'act': act, 'dil': dil}
    rec.update(time_designs(
        lambda plan: FB.bytenet_block_backward(x, p, q, *cd, dy, **kw, stats=st, plan=plan),
        ref, (B, L, D, H, dil), splits))
    times = {p: rec[f'device_ms_{p}'] for p in ('wgmma', 'mma_sync') if f'device_ms_{p}' in rec}
    rec['fastest'] = min(times, key=times.get)
    rec['occupancy'] = FB.k4_occupancy(FB.bytenet_block_backward_plan(B, L, D, H, K, dil, bf,
                                                                      path='wgmma'))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--shapes', choices=('paths', 'main'), default='paths')
    ap.add_argument('--splits', action='store_true')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('bytenet_bwd_sweep: needs a card', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({'card': smi, 'torch': torch.__version__}), flush=True)
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    misses, failed = [], []
    for B, L, D, act in (PATH_SHAPES if args.shapes == 'paths' else MAIN_SHAPES):
        for dil in DILATIONS:
            try:
                rec = measure(B, L, D, act, dil, args.splits, gen)
            except RuntimeError as e:
                failed.append([B, L, D, dil, str(e)[:300]])
                continue
            print(json.dumps(rec), flush=True)
            if rec['fastest'] != rec['path']:
                misses.append([B, L, D, dil, rec['path'], rec['fastest']])
            torch.cuda.empty_cache()
    print(json.dumps({'plan_not_fastest': misses, 'failed': failed}), flush=True)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
