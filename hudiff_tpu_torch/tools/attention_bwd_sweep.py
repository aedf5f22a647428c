"""K3's and K6's backward designs timed against each other on the card.

    python -m hudiff_tpu_torch.tools.attention_bwd_sweep [--shapes paths|main]
        [--splits] [--layouts qkv,sep]

prints one JSON line per shape and layout, then a summary line. For each
shape the paths give K3 (``--shapes paths``: B in 16, 32, 128, 512; L in
291, 152, 100, 37, 17; 8, 4 and 2 heads; ``main``: B = 128 and 512 at
L = 291 and 152, 8 heads) it runs the backward from K1's residuals on every
design that takes the shape (``rope_attention_bwd_plan``'s 'wgmma' and
'mma_sync'), holds each against the plain version given the same
residuals (bf16: |err| <= 2**-7 |ref| + 5e-3, the card tests' gate) and
checks that a repeat gives the same bits, and times each as device ms a
call: ``n`` calls captured in one CUDA graph, replayed, the median over
five replays. Beside them: the design the plan takes, ``fastest``, SDPA's
backward (``torch.autograd.grad`` through ``scaled_dot_product_attention``
on the rotated q, k, v, captured the same way) and, with ``--splits``, the
Hopper design at every split of a head's tiles and number of warpgroups
whose shared memory fits (``device_ms_by_split``, keys '<split>x<groups>').
Inputs are N(0, 1) from torch seed 0, bf16. The summary lists the shapes
where the plan's path is not the fastest. Needs a card; exits 2 without
one.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

from ..ops import fused_attention as FA
from ..ops.rope import rope_tables

PATH_SHAPES = [(B, L, H) for B in (16, 32, 128, 512) for L in (291, 152, 100, 37, 17)
               for H in (8, 4, 2)]
MAIN_SHAPES = [(B, L, 8) for B in (128, 512) for L in (291, 152)]
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 5e-3


def graph_ms(fn, n: int = 20, windows: int = 5, stream=None) -> float:
    """Device ms of one call of ``fn``: ``n`` calls captured in a CUDA graph
    after a warm-up call on a side stream (``stream``, where given: the one
    an autograd backward runs on), the median over ``windows`` replays."""
    fn()
    side = stream or torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    del graph
    return statistics.median(out)


def _excess(out, ref) -> float:
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() - BF16_RTOL * ref.abs()).max().item()


def sdpa_backward_ms(q, k, v, cos, sin, do, scale, heads) -> float:
    """Device ms of SDPA's backward alone (``graph_ms``) on the rotated q, k,
    v as [B, H, L, 64], with dO: the forward runs on the capture's stream,
    since autograd runs a backward on its forward's stream."""
    import torch.nn.functional as F
    from ..ops.rope import apply_rope
    B, L, A = q.shape
    bhld = lambda t: t.reshape(B, L, heads, -1).transpose(1, 2).contiguous()  # noqa: E731
    rot = lambda t: apply_rope(t.reshape(B, L, heads, -1), cos, sin).reshape(B, L, A)  # noqa: E731
    qr, kr, vr = (bhld(t).requires_grad_() for t in (rot(q), rot(k), v))
    dO = bhld(do)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        o = F.scaled_dot_product_attention(qr, kr, vr, scale=scale)
    return graph_ms(lambda: torch.autograd.grad(o, (qr, kr, vr), dO, retain_graph=True),
                    stream=stream)


def measure(B: int, L: int, heads: int, layout: str, splits: bool, gen) -> dict:
    """One shape: every design held and timed (see the module's doc)."""
    dev, dt, scale = torch.device('cuda'), torch.bfloat16, 0.125
    cos, sin = rope_tables(64, L, device=dev)
    qkv = torch.randn(B, L, heads * 192, generator=gen).to(dev, dt)
    do = torch.randn(B, L, heads * 64, generator=gen).to(dev, dt)
    _, o32, lse = FA.rope_attention_qkv_forward(qkv, cos, sin, scale, heads, residuals=True)
    q, k, v = FA.split_qkv_heads(qkv, heads)
    if layout == 'qkv':
        call = lambda plan: FA.rope_attention_qkv_backward(  # noqa: E731
            qkv, cos, sin, do, scale, heads, out=o32, lse=lse, plan=plan)
        ref = FA.rope_attention_qkv_backward_reference(qkv, cos, sin, do, scale, heads, o32, lse)
    else:
        q, k, v = (t.contiguous() for t in (q, k, v))
        call = lambda plan: torch.stack(FA.rope_attention_backward(  # noqa: E731
            q, k, v, cos, sin, do, scale, heads, out=o32, lse=lse, plan=plan))
        ref = torch.stack(FA.rope_attention_backward_reference(q, k, v, cos, sin, do, scale,
                                                               heads, o32, lse))
    chosen = FA.rope_attention_bwd_plan(B, L, heads, dt, layout=layout)
    rec = {'B': B, 'L': L, 'H': heads, 'layout': layout, 'path': chosen['path'],
           'grid': list(chosen['grid'])}
    held = True
    for path in ('wgmma', 'mma_sync'):
        try:
            plan = FA.rope_attention_bwd_plan(B, L, heads, dt, path=path, layout=layout)
        except ValueError:   # the design does not take this shape
            continue
        got, again = call(plan), call(plan)
        torch.cuda.synchronize()
        rec[f'excess_{path}'] = _excess(got, ref)
        rec[f'repeat_identical_{path}'] = torch.equal(got, again)
        held &= rec[f'excess_{path}'] <= BF16_ATOL and rec[f'repeat_identical_{path}'] \
            and bool(torch.isfinite(got).all())
        rec[f'device_ms_{path}'] = graph_ms(lambda: call(plan))
        if path == 'wgmma' and splits:
            rec['device_ms_by_split'] = {}
            for s in range(1, plan['tiles'] + 1):
                for groups in FA.K3_GROUPS:
                    try:
                        other = FA.rope_attention_bwd_plan(B, L, heads, dt, path=path, split=s,
                                                           groups=groups, layout=layout)
                    except ValueError:   # its shared memory does not fit a block
                        continue
                    key = f'{s}x{groups}'
                    if not torch.equal(got, call(other)):
                        held = False
                        rec.setdefault('split_differs', []).append(key)
                    rec['device_ms_by_split'][key] = graph_ms(lambda: call(other))
        del got, again
    times = {p: rec[f'device_ms_{p}'] for p in ('wgmma', 'mma_sync') if f'device_ms_{p}' in rec}
    rec['fastest'] = min(times, key=times.get)
    rec['library_device_ms'] = sdpa_backward_ms(q, k, v, cos, sin, do, scale, heads)
    rec['held'] = held
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--shapes', choices=('paths', 'main'), default='paths')
    ap.add_argument('--splits', action='store_true')
    ap.add_argument('--layouts', default='qkv')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('attention_bwd_sweep: needs a card', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({'card': smi, 'torch': torch.__version__}), flush=True)
    gen = torch.Generator().manual_seed(0)
    shapes = PATH_SHAPES if args.shapes == 'paths' else MAIN_SHAPES
    misses, failed = [], []
    for layout in args.layouts.split(','):
        for B, L, H in shapes:
            rec = measure(B, L, H, layout, args.splits, gen)
            print(json.dumps(rec), flush=True)
            if rec['fastest'] != rec['path']:
                misses.append([B, L, H, layout, rec['path'], rec['fastest']])
            if not rec['held']:
                failed.append([B, L, H, layout])
            torch.cuda.empty_cache()
    print(json.dumps({'plan_not_fastest': misses, 'failed': failed}), flush=True)
    return 1 if failed else 0


if __name__ == '__main__':
    sys.exit(main())
