"""K8: a whole attention layer (qkv projection, RoPE attention, out
projection) in one hand-written kernel pair, and the probe that times it
against the production split.

Counterpart of tools/fused_layer_probe.py. The CUDA kernels are
``csrc/fused_layer.cu``; its header says what bounds them on an H100 and
how the design answers that.

    python -m hudiff_tpu_torch.tools.fused_layer_probe [--device cpu] [--batch 1]

prints one JSON line with ``current_ms``, ``fused_ms``, ``speedup`` and
``rel_err`` at the JAX probe's shapes (B 64, L 291, d_model 768, att 512,
8 heads, bf16, weights from numpy seed 0) and the device they were taken
on. On a card the times come from CUDA events, each call's output fed back
as the next call's input; with ``--device cpu`` both layers run their
plain versions and the times are the host's.

Layouts. ``fused_layer`` reads the qkv projection's columns
column-blocked, ``[Q | K | V]`` with head h at columns h*64 of each block,
as the TPU kernel does (tools/fused_layer_probe.py:47-51). The production
layer (``current_layer``: cuBLAS projections around K1) reads them
head-major, ``[q_h | k_h | v_h]`` per head (pallas_attention.py:196-202).
The JAX probe hands both the same columns, so its parity check compares two
different functions. Here ``current_layer`` takes
``column_blocked_to_head_major`` of the same weights, so ``rel_err``
compares one function with itself.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import time

import numpy as np
import torch

from ..ops import _build
from ..ops.fused_attention import (_DTYPES, HEAD_DIM, _tables, merge_qkv_heads,
                                   rope_attention_qkv, rope_attention_reference)
from ..ops.rope import rope_tables
from ..utils.device import resolve_device

launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    'hd_fused_layer': [_P] * 10 + [_I] * 5 + [ctypes.c_float, _I, _P, _P],
    'hd_fused_layer_workspace_bytes': [_I] * 4,
    'hd_fused_layer_occupancy': [_I, _I, _P, _P],
}
_RESTYPES = {'hd_fused_layer_workspace_bytes': ctypes.c_longlong}

# the JAX probe's shapes (tools/fused_layer_probe.py:100)
L, D_MODEL, ATT, HEADS = 291, 768, 512, 8


def fused_layer_reference(x, wqkv, bqkv, wout, bout, cos, sin, scale: float,
                          heads: int) -> torch.Tensor:
    """Plain version of K8, with the TPU kernel's rounding points
    (tools/fused_layer_probe.py:34-64): the qkv product accumulated in f32
    and rounded to x's type, then ``bqkv`` added; q, k, v taken from the
    column-blocked qkv; each head's attention as ``rope_attention``
    computes it, rounded to x's type; the out product rounded, then ``bout``
    added. x [B, L, dm], wqkv [dm, 3A], wout [A, dm], all in x's type."""
    A = wqkv.shape[1] // 3
    qkv = (x.float() @ wqkv.float()).to(x.dtype) + bqkv
    o = rope_attention_reference(qkv[..., :A], qkv[..., A:2 * A], qkv[..., 2 * A:],
                                 cos, sin, scale, heads)
    return (o.float() @ wout.float()).to(x.dtype) + bout


def fused_layer(x, wqkv, bqkv, wout, bout, cos, sin, scale: float, heads: int) -> torch.Tensor:
    """The attention layer y [B, L, dm] of x [B, L, dm] with a column-blocked
    wqkv [dm, heads*3*64] and wout [heads*64, dm], every weight in x's
    type: K8 (two launches) on CUDA tensors, the plain version on CPU ones."""
    global launches
    if x.device.type == 'cpu':
        return fused_layer_reference(x, wqkv, bqkv, wout, bout, cos, sin, scale, heads)
    if x.device.type != 'cuda' or x.dtype not in _DTYPES:
        raise ValueError(f'fused_layer: unsupported device {x.device} or dtype {x.dtype}')
    B, Lx, dm = x.shape
    A = heads * HEAD_DIM
    shapes = {'wqkv': (wqkv, (dm, 3 * A)), 'bqkv': (bqkv, (3 * A,)),
              'wout': (wout, (A, dm)), 'bout': (bout, (dm,))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f'fused_layer: {name} must be {list(shape)} {x.dtype} on '
                             f'{x.device} (head dim {HEAD_DIM}), got {list(t.shape)} '
                             f'{t.dtype} on {t.device}')
    if dm % 64:
        raise ValueError(f'fused_layer: d_model must be a multiple of 64 (got {dm})')
    cos, sin = _tables(cos, sin, x, Lx, 'fused_layer')
    x, wqkv, bqkv, wout, bout = (t.contiguous() for t in (x, wqkv, bqkv, wout, bout))
    if x.dtype == torch.bfloat16:  # the bf16 kernels read them through TMA tensor maps
        for name, t in (('x', x), ('wqkv', wqkv), ('wout', wout)):
            if t.data_ptr() % 16:
                raise ValueError(f'fused_layer: bfloat16 {name} must start on a 16-byte '
                                 f'boundary (TMA), got address {t.data_ptr():#x}')
    lib = _build.load('fused_layer', _SIGNATURES, _RESTYPES)
    dtype = _DTYPES[x.dtype]
    n_ws = lib.hd_fused_layer_workspace_bytes(B, Lx, heads, dtype)
    ws = torch.empty(n_ws, dtype=torch.uint8, device=x.device) if n_ws else None
    o = torch.empty(B, Lx, A, dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    launched = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        code = lib.hd_fused_layer(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wout.data_ptr(), bout.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), o.data_ptr(), ws.data_ptr() if ws is not None
            else None, y.data_ptr(), B, Lx, dm, heads, HEAD_DIM, float(scale), dtype,
            torch.cuda.current_stream(x.device).cuda_stream, ctypes.addressof(launched))
    launches += launched.value
    _build.check(code, 'fused_layer')
    return y


# K8's two kernels by dtype, in launch order (csrc/fused_layer.cu)
KERNEL_NAMES = {torch.bfloat16: ('fused_layer_attn_wgmma_kernel', 'fused_layer_out_wgmma_kernel'),
                torch.float32: ('fused_layer_attn_f32_kernel', 'fused_layer_out_f32_kernel')}


def kernel_occupancy(length: int, dtype=torch.bfloat16) -> list:
    """For each of K8's two kernels at sequence length ``length`` (launch
    order): its name, the dynamic shared memory of a block and the blocks
    an SM of the current card holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    lib = _build.load('fused_layer', _SIGNATURES, _RESTYPES)
    smem, blocks = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    _build.check(lib.hd_fused_layer_occupancy(length, _DTYPES[dtype], ctypes.addressof(smem),
                                              ctypes.addressof(blocks)), 'fused_layer occupancy')
    return [{'kernel': name, 'smem_bytes': smem[i], 'blocks_per_sm': blocks[i]}
            for i, name in enumerate(KERNEL_NAMES[dtype])]


def column_blocked_to_head_major(wqkv: torch.Tensor, bqkv: torch.Tensor, heads: int):
    """The weight permutation that ``merge_qkv_heads`` applies to
    activations, applied to the columns: column-blocked [.., Q | K | V]
    -> head-major [.., q_h | k_h | v_h] per head. Returns (wqkv, bqkv)."""
    A = wqkv.shape[-1] // 3

    def merge(t):
        return merge_qkv_heads(t[..., :A], t[..., A:2 * A], t[..., 2 * A:], heads)

    return merge(wqkv), merge(bqkv)


def current_layer(x, wqkv, bqkv, wout, bout, cos, sin, scale: float, heads: int) -> torch.Tensor:
    """The production split (tools/fused_layer_probe.py:90-93): the qkv
    projection by torch.matmul (cuBLAS on a card), K1 on the head-major
    qkv, the out projection by torch.matmul. ``wqkv``/``bqkv`` head-major."""
    qkv = x @ wqkv.to(x.dtype) + bqkv.to(x.dtype)
    o = rope_attention_qkv(qkv, cos, sin, scale, heads)
    return o @ wout.to(x.dtype) + bout.to(x.dtype)


def probe_inputs(batch: int, device, dtype=torch.bfloat16, seed: int = 0):
    """x and the column-blocked weights of the JAX probe's main() (the same
    numpy draws, in its order), plus the [L, 32] RoPE tables and the scale."""
    rs = np.random.RandomState(seed)
    draws = (rs.randn(batch, L, D_MODEL) * 0.1, rs.randn(D_MODEL, 3 * ATT) * 0.02,
             rs.randn(3 * ATT) * 0.01, rs.randn(ATT, D_MODEL) * 0.02, rs.randn(D_MODEL) * 0.01)
    x, wqkv, bqkv, wout, bout = (torch.tensor(a, dtype=torch.float32).to(device, dtype)
                                 for a in draws)
    cos, sin = rope_tables(ATT // HEADS, L, device=device)
    return x, wqkv, bqkv, wout, bout, cos, sin, 1.0 / float(np.sqrt(ATT // HEADS))


def scan_time(fn, x0: torch.Tensor, n: int = 10, windows: int = 3) -> float:
    """Milliseconds per call of ``fn``, each call's output fed back as the
    next call's input (the counterpart of tools/perf_breakdown.py::
    _scan_time), after one warm-up call: the median over ``windows``
    windows of ``n`` chained calls, timed by CUDA events on a card and by
    the host clock on the CPU."""
    x = fn(x0)
    per_window = []
    for _ in range(windows):
        if x.device.type == 'cuda':
            torch.cuda.synchronize(x.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                x = fn(x)
            end.record()
            end.synchronize()
            per_window.append(start.elapsed_time(end) / n)
        else:
            t0 = time.perf_counter()
            for _ in range(n):
                x = fn(x)
            per_window.append((time.perf_counter() - t0) / n * 1e3)
    return statistics.median(per_window)


def measure(device='cuda', batch: int = 64, dtype=torch.bfloat16, reps: int = 10) -> dict:
    """The probe's numbers: both layers on the same weights (permuted to
    head-major for ``current_layer``), their max |difference| over the
    current layer's max |value|, and their times."""
    dev = resolve_device(device)
    x, wqkv, bqkv, wout, bout, cos, sin, scale = probe_inputs(batch, dev, dtype)
    wqkv_hm, bqkv_hm = column_blocked_to_head_major(wqkv, bqkv, HEADS)

    def fused(c):
        return fused_layer(c, wqkv, bqkv, wout, bout, cos, sin, scale, HEADS)

    def current(c):
        return current_layer(c, wqkv_hm, bqkv_hm, wout, bout, cos, sin, scale, HEADS)

    with torch.no_grad():
        a, b = fused(x).float(), current(x).float()
        rel_err = ((a - b).abs().max() / (b.abs().max() + 1e-9)).item()
        t_cur, t_fus = scan_time(current, x, reps), scan_time(fused, x, reps)
    return {'current_ms': t_cur, 'fused_ms': t_fus, 'speedup': t_cur / t_fus,
            'rel_err': rel_err, 'B': batch, 'L': L, 'd_model': D_MODEL, 'att': ATT,
            'heads': HEADS, 'dtype': str(dtype).split('.')[-1],
            'device': torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    p.add_argument('--batch', type=int, default=64,
                   help='rows (64, the probe\'s; 1 keeps a CPU run short)')
    args = p.parse_args(argv)
    print(json.dumps(measure(args.device, args.batch)))


if __name__ == '__main__':
    main()
