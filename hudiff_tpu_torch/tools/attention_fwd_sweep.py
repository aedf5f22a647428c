"""K1's, K5's and K7's forward designs timed against each other on the card.

    python -m hudiff_tpu_torch.tools.attention_fwd_sweep [--shapes paths|main]
        [--layouts qkv,sep,blhd,bhld]

prints one JSON line per shape and layout, then a summary line. For each
shape (``--shapes paths``: B in 1, 16, 64, 128, 512; L in 291 and 152; 8, 4
and 2 heads, the shapes the paths and entry points give the forward;
``main``: B = 16 and 64 at L = 291, 8 heads) and layout ('qkv' K1, 'sep'
K5, 'blhd' and 'bhld' K7, ``rope_attention_qkv_plan``'s layouts) it runs
the forward on every design that takes the shape ('wgmma' and
'mma_sync'), holds each against the plain version (bf16: |err| <= 2**-7
|ref| + 5e-3, the card tests' gate), and times each as device ms a call
(``attention_bwd_sweep.graph_ms``: ``n`` calls captured in one CUDA graph,
replayed, the median over five replays); K1 and K5 also with the
backward's residuals (``*_res``). Beside them: the design the plan takes,
``fastest`` (``fastest_res`` with the residuals), and SDPA on the same q, k, v ([B, H, L, 64], q and k rotated
where the kernel rotates). Inputs are N(0, 1) from torch seed 0, bf16. The
summary lists the shapes where the plan's path is not the fastest (the
layout marked ``_res`` where that is so with the residuals). Needs a
card; exits 2 without one. ``time_designs`` is the timing itself, which
chip_smoke.py's K1, K5 and K7 records also take.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import fused_attention as FA
from ..ops.rope import apply_rope, rope_tables
from .attention_bwd_sweep import graph_ms

LAYOUTS = ('qkv', 'sep', 'blhd', 'bhld')
PATH_SHAPES = [(B, L, H) for B in (1, 16, 64, 128, 512) for L in (291, 152) for H in (8, 4, 2)]
MAIN_SHAPES = [(B, 291, 8) for B in (16, 64)]
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 5e-3


def _excess(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() - BF16_RTOL * ref.abs()).max().item()


def _calls(layout: str, q, k, v, cos, sin, scale: float, heads: int):
    """(call(plan, residuals), reference output, SDPA's q, k, v) for one
    layout on the same values: q, k, v [B, L, heads*64]."""
    B, L, A = q.shape
    split = lambda t: t.reshape(B, L, heads, A // heads)  # noqa: E731
    bhld = lambda t: t.transpose(1, 2).contiguous()  # noqa: E731
    rotated = [bhld(apply_rope(split(t), cos, sin)) for t in (q, k)] + [bhld(split(v))]
    if layout == 'qkv':
        qkv = FA.merge_qkv_heads(q, k, v, heads)
        return (lambda pl, res: FA.rope_attention_qkv_forward(qkv, cos, sin, scale, heads, res,
                                                              plan=pl),
                FA.rope_attention_qkv_reference(qkv, cos, sin, scale, heads), rotated)
    if layout == 'sep':
        return (lambda pl, res: FA.rope_attention_forward(q, k, v, cos, sin, scale, heads, res,
                                                          plan=pl),
                FA.rope_attention_reference(q, k, v, cos, sin, scale, heads), rotated)
    plain = [bhld(split(t)) for t in (q, k, v)]
    ref = FA.attention_reference(*(split(t) for t in (q, k, v)), scale)
    if layout == 'blhd':
        ins = [split(t) for t in (q, k, v)]
        return (lambda pl, res: FA.attention(*ins, scale, plan=pl), ref, plain)
    return (lambda pl, res: FA.fused_attention(*plain, scale, plan=pl).transpose(1, 2), ref, plain)


def time_designs(call, held, shape, heads: int, layout: str, sdpa, scale: float,
                 residuals: bool = False) -> dict:
    """The bf16 forward at ``shape`` (B, L) in ``layout`` on each design
    that takes it ('wgmma', 'mma_sync'): ``call(plan, residuals)`` runs it,
    and ``held(path, out)`` holds the output to the kernel's limits (it
    raises where the output is off) before the design is timed. Returns the
    device ms of each (``device_ms_<path>``; with ``residuals`` also
    ``device_ms_<path>_res``, the call writing the backward's residuals),
    ``device_ms`` of the plan's design, and SDPA's on ``sdpa()``'s q, k, v
    (``library_device_ms``)."""
    B, L = shape
    dt = torch.bfloat16
    rec = {'path': FA.rope_attention_qkv_plan(B, L, heads, dt, layout=layout)['path']}
    for path in ('wgmma', 'mma_sync'):
        plan = FA.rope_attention_qkv_plan(B, L, heads, dt, path=path, layout=layout)
        held(path, call(plan, False))
        rec[f'device_ms_{path}'] = graph_ms(lambda: call(plan, False))
        if residuals:
            rec[f'device_ms_{path}_res'] = graph_ms(lambda: call(plan, True))
    rec['device_ms'] = rec[f"device_ms_{rec['path']}"]
    qb, kb, vb = sdpa()
    rec['library_device_ms'] = graph_ms(lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                                               scale=scale))
    return rec


def measure(B: int, L: int, heads: int, layout: str, gen) -> dict:
    """One shape and layout: the plan's path, each design's error and
    device ms (K1 and K5 also with the residuals), SDPA's device ms."""
    dt, scale = torch.bfloat16, 0.125
    q, k, v = (torch.randn(B, L, heads * 64, generator=gen).to('cuda', dt) for _ in range(3))
    cos, sin = rope_tables(64, L, device='cuda')
    call, ref, sdpa = _calls(layout, q, k, v, cos, sin, scale, heads)
    rec = {'B': B, 'L': L, 'heads': heads, 'layout': layout}

    def held(path, out):
        rec[f'excess_{path}'] = _excess(out, ref)
        if rec[f'excess_{path}'] > BF16_ATOL or not bool(torch.isfinite(out).all()):
            raise SystemExit(f'{layout} ({path}) off its plain version at B={B} L={L} '
                             f'H={heads}: excess {rec[f"excess_{path}"]}')

    rec.update(time_designs(call, held, (B, L), heads, layout, lambda: sdpa, scale,
                            residuals=layout in ('qkv', 'sep')))
    for res in ('', '_res')[:1 + ('device_ms_wgmma_res' in rec)]:
        rec[f'fastest{res}'] = min(('wgmma', 'mma_sync'),
                                   key=lambda p: rec[f'device_ms_{p}{res}'])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--shapes', choices=('paths', 'main'), default='main')
    ap.add_argument('--layouts', default=','.join(LAYOUTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('attention_fwd_sweep: needs an NVIDIA GPU', file=sys.stderr)
        return 2
    layouts = args.layouts.split(',')
    if not set(layouts) <= set(LAYOUTS):
        ap.error(f'--layouts takes {",".join(LAYOUTS)}')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True)
    print(json.dumps({'device': torch.cuda.get_device_name(0), 'nvidia_smi': smi.stdout.strip()}),
          flush=True)
    gen = torch.Generator().manual_seed(0)
    slower = []
    for B, L, heads in (PATH_SHAPES if args.shapes == 'paths' else MAIN_SHAPES):
        for layout in layouts:
            rec = measure(B, L, heads, layout, gen)
            print(json.dumps(rec), flush=True)
            for res in ('', '_res'):
                fastest = rec.get(f'fastest{res}', rec['path'])
                if fastest != rec['path']:
                    slower.append([B, L, heads, layout + res, rec['path'],
                                   rec[f"device_ms_{rec['path']}{res}"],
                                   rec[f'device_ms_{fastest}{res}']])
            torch.cuda.empty_cache()
    print(json.dumps({'plan_not_fastest': slower}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
