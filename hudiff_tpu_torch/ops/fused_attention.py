"""K1, K3, K5, K6 and K7: the fused attention kernels, forward and backward.

Counterpart of hudiff_tpu/ops/pallas_attention.py:

- ``rope_attention_qkv``: RoPE attention over a head-major merged qkv
  projection; K1 forward (``_rope_fwd_kernel_qkv``), K3 backward
  (``_rope_bwd_kernel_qkv``), the custom VJP of :320-337;
- ``rope_attention_qkv_tp``: the same on a tensor-parallel rank's heads
  (:361-404);
- ``rope_attention``: the same on separate q, k, v; K5 forward
  (``_rope_fwd_kernel``), K6 backward (``_rope_bwd_kernel``), the custom
  VJP of :171-188;
- ``fused_attention`` ([B, H, L, D]) and ``attention`` ([B, L, H, D]):
  softmax attention without RoPE, forward only; K7 (``_attn_kernel``).

The CUDA kernels are ``csrc/rope_attention.cu`` (K1, K5 and K7: one
forward, four layouts; bf16 at L <= 384 with 64 or more (b, h) pairs on
Hopper's TMA + wgmma, the rest on mma.sync or, in f32, FMA) and
``csrc/rope_attention_bwd.cu`` (K3 and K6: one three-launch backward, two
layouts; bf16 at L <= 384 on TMA + wgmma, the rest on mma.sync or, in f32,
FMA); their headers say what bounds them on an H100 and how their designs
answer that. ``rope_attention_qkv_plan`` (K1, K5 and K7, by ``layout``) and
``rope_attention_bwd_plan`` (K3, K6) compute each launch here from the
shape alone; the C entries refuse any plan but their own, and ``plan=`` on
the wrappers runs another design on the same inputs (chip_smoke.py's
comparisons).

The backward works from the forward's residuals, which K1 and K5 write
when asked (``residuals=True``): the output before rounding, ``out`` f32
[B, L, heads*64] (P v with P in f32), and the row log-sum-exp ``lse``
[B, heads, L] f32 of the scaled scores. The JAX custom VJPs save the inputs
alone and recompute the softmax; the autograd Functions here save the
residuals beside them, and a backward called on CUDA tensors without them
runs the forward first. On the CPU the backward's plain version is the TPU
kernel's arithmetic, which needs no residuals;
``rope_attention_backward_reference(..., out, lse)`` is the kernels'
arithmetic from them, their plain version on the card.

Every wrapper routes by the tensor's device alone: a CPU tensor takes the
plain versions below, a CUDA tensor launches the kernels (or raises). When
a gradient is needed ``rope_attention_qkv`` and ``rope_attention`` go
through ``torch.autograd.Function``s whose backwards are K3 and K6;
otherwise (``torch.inference_mode()``, ``no_grad``, or inputs that need no
grad) they call the forward kernel directly. K7 has no backward: a CUDA
input that needs a gradient raises. Launch counters: ``launches`` (K1),
``bwd_launches`` (the kernels K3's C entry reports, three per call),
``rope_launches`` (K5), ``rope_bwd_launches`` (K6, three per call) and
``attention_launches`` (K7), named in ``COUNTERS``. A wrapper called while
a CUDA graph captures counts its kernels once, though none ran; the graph
sampler (sampling/sampler.py) takes that capture's counts back and adds
them again at each replay, so the counters stay the kernels launched.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .rope import apply_rope, apply_rope_inverse

HEAD_DIM = 64
launches = 0
bwd_launches = 0
rope_launches = 0
rope_bwd_launches = 0
attention_launches = 0
COUNTERS = ('launches', 'bwd_launches', 'rope_launches', 'rope_bwd_launches',
            'attention_launches')

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'hd_rope_attention_qkv': [_P] * 6 + [_I] * 4 + [_F, _I, _P],
    'hd_rope_attention_qkv_tma': [_P] * 6 + [_I] * 3 + [_F, _P, _P],
    'hd_rope_attention': [_P] * 8 + [_I] * 4 + [_F, _I, _P],
    'hd_attention': [_P] * 4 + [_I] * 10 + [_F, _I, _P],
    'hd_rope_attention_tma': [_P] * 8 + [_I] * 3 + [_F, _P, _P],
    'hd_attention_tma': [_P] * 4 + [_I] * 4 + [_F, _P, _P],
}
_BWD_SIGNATURES = {
    'hd_rope_attention_qkv_bwd': [_P] * 9 + [_I] * 4 + [_F, _I, _P, _P],
    'hd_rope_attention_bwd': [_P] * 13 + [_I] * 4 + [_F, _I, _P, _P],
    'hd_rope_attention_qkv_bwd_tma': [_P] * 8 + [_I] * 3 + [_F, _P, _P, _P],
    'hd_rope_attention_bwd_tma': [_P] * 12 + [_I] * 3 + [_F, _P, _P, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# K1's, K5's and K7's launch on the H100 (csrc/rope_attention.cu): the Hopper
# path's block is two warpgroups (thread 0 issues every copy); a 64-row tile
# of 64 bf16 columns is 8 KB with 128-byte rows (TMA's 128-byte swizzle); K
# and V stay in shared memory up to MAX_KV_TILES tiles (L = 384).
MAX_SMEM = 232448        # dynamic shared memory an H100 block may use
H100_SMS = 132
TILE_BYTES = 64 * 128
K1_TMA_THREADS = 4 * 2 * 32
K1_MAX_KV_TILES = 6
K1_TMA_MIN_HEADS = 64    # (b, h) pairs below which the mma.sync design's 5x blocks win
K1_TMA_EXTRA = 128 + 1024   # the mbarriers, and the base rounded up to 1024 bytes
K1_PATHS = ('wgmma', 'mma_sync', 'fma')
# The forward's layouts: K1's merged head-major qkv, K5's separate q, k, v
# [B, L, H*64], K7's [B, L, H, 64] (``attention``) and [B, H, L, 64]
# (``fused_attention``); K1 and K5 rotate q and k, K7 does not.
FWD_LAYOUTS = {'qkv': ('rope_attention_qkv', True), 'sep': ('rope_attention', True),
               'blhd': ('attention', False), 'bhld': ('fused_attention', False)}
_MMA_SYNC_SMEM = {torch.float32: 104448, torch.bfloat16: 5 * 9216}   # SmemF32, SmemBf16


def _bf16_map(dims) -> dict:
    """A 3-D bf16 tensor map over [dims[2]][dims[1]][dims[0]] with 64 x 64
    boxes and 128-byte swizzle."""
    return {'dims': tuple(dims), 'strides': (dims[0] * 2, dims[1] * dims[0] * 2),
            'box': (HEAD_DIM, 64, 1), 'elem_bytes': 2, 'swizzle': 128}


@functools.lru_cache(maxsize=None)
def rope_attention_qkv_plan(B: int, L: int, heads: int, dtype, path: str = None,
                            split: int = None, layout: str = 'qkv') -> dict:
    """The attention forward's launch on an H100, from the shape alone, for
    ``layout`` (``FWD_LAYOUTS``): 'qkv' (K1, qkv [B, L, heads*3*64]), 'sep'
    (K5, q, k, v [B, L, heads*64]), 'blhd' (K7 through ``attention``) or
    'bhld' (K7 through ``fused_attention``) of ``dtype``; the plan's
    ``rope`` (K1 and K5 rotate q and k, K7 does not) follows the layout.
    ``path`` 'wgmma' (bf16, L <= 384 and B * heads >= 64: TMA + wgmma, K
    and V held in shared memory), else 'mma_sync' (bf16, the earlier
    design, which reads faster with fewer (b, h) pairs: it splits a head
    into a block per 64 queries) or 'fma' (f32); ``grid``,
    ``threads``, ``smem_bytes``, and for 'wgmma' the K/V tiles, the tensor
    map q, k and v are each read through (dims and box innermost first,
    byte strides, 128-byte swizzle: over qkv [B][L][heads*192], over q, k,
    v [B][L][heads*64], or for 'bhld' over [B*heads][L][64]) and ``array``,
    the 14 values the C entry takes (also as a ctypes array, ``c_array``;
    plans are cached by shape). A head's query tiles are split over
    ``split`` blocks (each loads and rotates K and V itself): 2 where a head
    has 4 or more query tiles or there are at most two (b, h) blocks an SM,
    else 1 (the split that read fastest on an H100, PERF.md). ``path`` and
    ``split`` name another launch for comparison, where it applies; what no
    kernel takes raises."""
    if layout not in FWD_LAYOUTS:
        raise ValueError(f'rope_attention_qkv_plan: layout {layout!r} is not one of '
                         f'{tuple(FWD_LAYOUTS)}')
    what, rotates = FWD_LAYOUTS[layout]
    if dtype not in _DTYPES:
        raise TypeError(f'{what}: dtype {dtype} not supported')
    if not (0 < B <= 65535 and 0 < heads <= 65535 and L > 0):
        raise ValueError(f'{what}: unsupported shape B={B} L={L} heads={heads}')
    tiles = -(-L // 64)
    bf16 = dtype is torch.bfloat16
    takes = bf16 and tiles <= K1_MAX_KV_TILES
    fits = takes and B * heads >= K1_TMA_MIN_HEADS
    path = path or ('wgmma' if fits else 'mma_sync' if bf16 else 'fma')
    if path not in K1_PATHS or (path == 'wgmma' and not takes) \
            or (path == 'mma_sync' and not bf16) or (path == 'fma' and bf16):
        raise ValueError(f'{what}: no {path!r} path for {dtype} at L={L}')
    if path != 'wgmma':
        return {'path': path, 'layout': layout, 'rope': rotates, 'grid': (tiles, heads, B),
                'threads': 128, 'cluster': (1, 1, 1), 'smem_bytes': _MMA_SYNC_SMEM[dtype]}
    if split is None:   # two blocks a head where a head has 4+ query tiles or blocks are few
        split = 2 if tiles >= 2 and (tiles >= 4 or B * heads <= 2 * H100_SMS) else 1
    if not 1 <= split <= tiles:
        raise ValueError(f'{what}: split {split} of {tiles} query tiles')
    A = heads * HEAD_DIM
    dims = {'qkv': (3 * A, L, B), 'sep': (A, L, B), 'blhd': (A, L, B),
            'bhld': (HEAD_DIM, L, B * heads)}[layout]
    plan = {'path': 'wgmma', 'layout': layout, 'rope': rotates, 'grid': (split, heads, B),
            'threads': K1_TMA_THREADS, 'cluster': (1, 1, 1), 'kv_tiles': tiles,
            'smem_bytes': (2 * tiles + -(-tiles // split)) * TILE_BYTES + K1_TMA_EXTRA,
            'tensor_map': _bf16_map(dims)}
    tm = plan['tensor_map']
    plan['array'] = (*plan['grid'], plan['threads'], plan['smem_bytes'], tiles, *tm['dims'],
                     *tm['strides'], *tm['box'])
    plan['c_array'] = (ctypes.c_longlong * len(plan['array']))(*plan['array'])
    return plan


# K3's and K6's launch (csrc/rope_attention_bwd.cu): the Hopper passes' block
# is one or two warpgroups (no producer warp); a head's walked pair stays in
# shared memory up to K3_MAX_TILES tiles (L = 384). The prologue (128
# threads) comes first on every path.
K3_MAX_TILES = 6
K3_MIN_BLOCKS = 128      # a head's tiles are split over more blocks until the grid has this many
K3_GROUPS = (1, 2)
K3_LAYOUTS = ('qkv', 'sep')
_BWD_MMA_SYNC_SMEM = {torch.float32: 139776, torch.bfloat16: 6 * 9216 + 4 * 64 * 4}


def _bwd_tma_smem(tiles: int, split: int, L: int) -> int:
    """A Hopper pass's shared memory: the walked pair's 2 T tiles, two per
    resident tile, the head's lse and delta (T * 64 f32 each), the cos and
    sin tables (L * 32 f32 each), the mbarriers and the base's rounding to
    1024 bytes."""
    resident = -(-tiles // split)
    return ((2 * tiles + 2 * resident) * TILE_BYTES + 2 * tiles * 64 * 4
            + 2 * L * HEAD_DIM // 2 * 4 + K1_TMA_EXTRA)


@functools.lru_cache(maxsize=None)
def rope_attention_bwd_plan(B: int, L: int, heads: int, dtype, path: str = None,
                            split: int = None, groups: int = None,
                            layout: str = 'qkv') -> dict:
    """K3's (``layout`` 'qkv': q, k, v in the merged head-major qkv) or K6's
    ('sep': separate q, k, v) backward launch on an H100, from the shape
    alone: ``path`` 'wgmma' (bf16, L <= 384: TMA + wgmma, a head's walked
    pair held in shared memory), else 'mma_sync' (bf16, the earlier design)
    or 'fma' (f32); ``grid``, ``threads`` and ``smem_bytes`` of the two
    passes (the prologue's are (tiles, heads, B) and 128 threads on every
    path), and for 'wgmma' the tiles, ``groups``
    (warpgroups a block), the tensor maps of q, k, v and dO (dims and box
    innermost first, byte strides) and ``array``, the values the C entry
    takes and checks (also as ``c_array``; plans are cached by shape). A
    block takes every split-th of a head's 64-row tiles, each warpgroup one
    at a time; ``split`` defaults to the fewest blocks a head whose shared
    memory (the tiles, the statistics and the cos and sin tables) fits,
    raised while the grid has fewer than K3_MIN_BLOCKS blocks, ``groups``
    to 2 where a block has tiles to share and the head 3 or more (the
    launches that read fastest on an H100 at the paths' shapes, PERF.md);
    they and ``path`` name another launch for comparison; what no kernel
    takes raises."""
    what = 'rope_attention_bwd_plan'
    if dtype not in _DTYPES:
        raise TypeError(f'{what}: dtype {dtype} not supported')
    if layout not in K3_LAYOUTS:
        raise ValueError(f'{what}: layout {layout!r} is not one of {K3_LAYOUTS}')
    if not (0 < B <= 65535 and 0 < heads <= 65535 and L > 0):
        raise ValueError(f'{what}: unsupported shape B={B} L={L} heads={heads}')
    tiles = -(-L // 64)
    bf16 = dtype is torch.bfloat16
    takes = bf16 and tiles <= K3_MAX_TILES
    path = path or ('wgmma' if takes else 'mma_sync' if bf16 else 'fma')
    if path not in K1_PATHS or (path == 'wgmma' and not takes) \
            or (path == 'mma_sync' and not bf16) or (path == 'fma' and bf16):
        raise ValueError(f'{what}: no {path!r} path for {dtype} at L={L}')
    if path != 'wgmma':
        return {'path': path, 'grid': (tiles, heads, B), 'threads': 128,
                'smem_bytes': _BWD_MMA_SYNC_SMEM[dtype]}
    fits = lambda x: _bwd_tma_smem(tiles, x, L) <= MAX_SMEM  # noqa: E731
    if split is None:   # the fewest blocks a head that fit, more while the grid is small
        split = next(x for x in range(1, tiles + 1) if fits(x))
        while split < tiles and B * heads * split < K3_MIN_BLOCKS:
            split += 1
    if groups is None:  # two warpgroups where a block has 3 or more tiles to share
        groups = 2 if 1 <= split < tiles and tiles > 2 else 1
    if not 1 <= split <= tiles or groups not in K3_GROUPS or not fits(split):
        raise ValueError(f'{what}: split {split} of {tiles} tiles, {groups} warpgroups')
    A = heads * HEAD_DIM
    width = 3 * A if layout == 'qkv' else A
    maps = {'q': _bf16_map((width, L, B)), 'k': _bf16_map((width, L, B)),
            'v': _bf16_map((width, L, B)), 'do': _bf16_map((A, L, B))}
    plan = {'path': 'wgmma', 'grid': (split, heads, B), 'threads': 128 * groups,
            'groups': groups, 'tiles': tiles, 'smem_bytes': _bwd_tma_smem(tiles, split, L),
            'tensor_maps': maps}
    plan['array'] = (*plan['grid'], plan['threads'], plan['smem_bytes'], tiles,
                     *(v for m in maps.values() for k in ('dims', 'strides', 'box')
                       for v in m[k]))
    plan['c_array'] = (ctypes.c_longlong * len(plan['array']))(*plan['array'])
    return plan


def split_qkv_heads(qkv: torch.Tensor, heads: int):
    """Head-major merged qkv [B, L, H*3*D] -> (q, k, v) each [B, L, H*D]."""
    B, L, A3 = qkv.shape
    hd = A3 // 3 // heads
    g = qkv.reshape(B, L, heads, 3, hd)
    return tuple(g[:, :, :, i].reshape(B, L, heads * hd) for i in range(3))


def merge_qkv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """(q, k, v) each [..., H*D] -> head-major merged qkv [..., H*3*D]
    (pallas_attention.py:215-221, for any leading dimensions)."""
    *lead, A = q.shape
    hd = A // heads
    return torch.stack([t.reshape(*lead, heads, hd) for t in (q, k, v)],
                       dim=-2).reshape(*lead, 3 * A)


# -- plain versions -----------------------------------------------------------

def rope_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             cos: torch.Tensor, sin: torch.Tensor, scale: float,
                             heads: int, residuals: bool = False):
    """Plain version of K5 (pallas_attention.py:425-432): q/k rotated in
    f32 and rounded to their type, scores of input-type values accumulated
    in f32 and scaled after the product, softmax over all L, P cast to v's
    type, P v accumulated in f32. q, k, v [B, L, H*D]; returns [B, L, H*D]
    in v's type. With ``residuals`` it returns (out, out_f32, lse), the
    backward's residuals as the kernels write them: out_f32 = P v with P in
    f32, in f32 [B, L, H*D], and lse the scaled scores' row log-sum-exp
    [B, H, L] f32."""
    B, L, A = q.shape
    D = A // heads
    qh = apply_rope(q.reshape(B, L, heads, D), cos, sin)
    kh = apply_rope(k.reshape(B, L, heads, D), cos, sin)
    vh = v.reshape(B, L, heads, D)
    logits = torch.einsum('blhd,bmhd->bhlm', qh.float(), kh.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum('bhlm,bmhd->blhd', probs.to(v.dtype).float(), vh.float())
    out = out.reshape(B, L, A).to(v.dtype)
    if not residuals:
        return out
    out_f32 = torch.einsum('bhlm,bmhd->blhd', probs, vh.float()).reshape(B, L, A)
    return out, out_f32, torch.logsumexp(logits, dim=-1)


def rope_attention_qkv_reference(qkv: torch.Tensor, cos: torch.Tensor,
                                 sin: torch.Tensor, scale: float,
                                 heads: int, residuals: bool = False):
    """Plain version of K1: ``rope_attention_reference`` on the split
    head-major qkv [B, L, H*3*D]; returns [B, L, H*D] (and the residuals)."""
    return rope_attention_reference(*split_qkv_heads(qkv, heads), cos, sin, scale, heads,
                                    residuals)


def rope_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      cos: torch.Tensor, sin: torch.Tensor,
                                      do: torch.Tensor, scale: float, heads: int,
                                      out: torch.Tensor = None, lse: torch.Tensor = None):
    """Plain version of K6: the gradients of ``rope_attention`` with
    respect to q, k and v, by explicit formulas in the TPU kernel's order
    and rounding (pallas_attention.py:100-133): q/k rotated in f32 and
    rounded to the input type; products of input-type values accumulated
    in f32; P recomputed in f32, ``ph``, ``ds`` and ``do`` in the input
    type; delta = rowsum(dP * P); dq/dk scaled, rotated back in f32 and
    rounded. Given the forward's residuals (``out``, its output before
    rounding, f32 [B, L, H*D], and ``lse`` [B, H, L]) it takes the kernels'
    arithmetic instead: P = exp(S - lse) and delta = rowsum(do * out).
    Returns (dq, dk, dv), each [B, L, H*D] in q's type."""
    if (out is None) != (lse is None):
        raise ValueError('rope_attention_backward_reference: give both out and lse, or neither')
    cd = q.dtype
    B, L, A = q.shape
    D = A // heads
    qh = apply_rope(q.reshape(B, L, heads, D), cos, sin).float()
    kh = apply_rope(k.reshape(B, L, heads, D), cos, sin).float()
    vh = v.reshape(B, L, heads, D).float()
    doh = do.to(cd).reshape(B, L, heads, D).float()
    st = torch.einsum('blhd,bmhd->bhlm', qh, kh) * scale
    p = torch.softmax(st, dim=-1) if lse is None else torch.exp(st - lse.float()[..., None])
    ph = p.to(cd).float()
    dv = torch.einsum('bhlm,blhd->bmhd', ph, doh)
    dp = torch.einsum('blhd,bmhd->bhlm', doh, vh)
    if out is None:
        delta = (dp * p).sum(dim=-1, keepdim=True)
    else:
        oh = out.float().reshape(B, L, heads, D)
        delta = (doh * oh).sum(dim=-1).transpose(1, 2)[..., None]
    ds = (p * (dp - delta)).to(cd).float()
    dq = torch.einsum('bhlm,bmhd->blhd', ds, kh) * scale
    dk = torch.einsum('bhlm,blhd->bmhd', ds, qh) * scale
    dq = apply_rope_inverse(dq, cos, sin).to(cd)
    dk = apply_rope_inverse(dk, cos, sin).to(cd)
    return tuple(t.reshape(B, L, A) for t in (dq, dk, dv.to(cd)))


def rope_attention_qkv_backward_reference(qkv: torch.Tensor, cos: torch.Tensor,
                                          sin: torch.Tensor, do: torch.Tensor,
                                          scale: float, heads: int,
                                          out: torch.Tensor = None,
                                          lse: torch.Tensor = None) -> torch.Tensor:
    """Plain version of K3 (pallas_attention.py:248-284, the same formulas
    as K6 on the split qkv, from the residuals when given): returns
    head-major dqkv [B, L, H*3*D] in qkv's type."""
    grads = rope_attention_backward_reference(*split_qkv_heads(qkv, heads), cos, sin, do,
                                              scale, heads, out, lse)
    return merge_qkv_heads(*grads, heads)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain version of K7 (pallas_attention.py:481-485): softmax(q k^T *
    scale) v over [B, L, H, D], scores of input-type values accumulated in
    f32, P cast to v's type, P v accumulated in f32; returns [B, L, H, D]
    in v's type."""
    logits = torch.einsum('blhd,bmhd->bhlm', q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum('bhlm,bmhd->blhd', probs.float(), v.float()).to(v.dtype)


# -- the kernels' wrappers ----------------------------------------------------

def _check_cuda(x: torch.Tensor, width: int, what: str) -> None:
    if x.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {x.device}')
    if x.dtype not in _DTYPES:
        raise TypeError(f'{what}: dtype {x.dtype} not supported')
    if x.shape[-1] != width:
        raise ValueError(f'{what}: head dim must be {HEAD_DIM} (got width {x.shape[-1]}, '
                         f'expected {width})')


def _check_same(ts, what: str) -> None:
    first = ts[0]
    for t in ts[1:]:
        if t.shape != first.shape or t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f'{what}: q, k, v (and do) must share shape, dtype and device')


def _check_residuals(out, lse, x, B, L, heads, what):
    """The forward's residuals on x's device, contiguous: ``out``, its
    output before rounding, f32 [B, L, heads*64], and ``lse`` f32
    [B, heads, L]."""
    if out.shape != (B, L, heads * HEAD_DIM) or out.dtype != torch.float32 \
            or out.device != x.device:
        raise ValueError(f'{what}: out must be the forward\'s f32 output, [{B}, {L}, '
                         f'{heads * HEAD_DIM}] float32 on {x.device}')
    if lse.shape != (B, heads, L) or lse.dtype != torch.float32 or lse.device != x.device:
        raise ValueError(f'{what}: lse must be [{B}, {heads}, {L}] float32 on {x.device}')
    return out.contiguous(), lse.contiguous()


def _tables(cos, sin, x, L, what):
    cos = cos.to(device=x.device, dtype=torch.float32).contiguous()
    sin = sin.to(device=x.device, dtype=torch.float32).contiguous()
    if cos.shape != (L, HEAD_DIM // 2) or sin.shape != cos.shape:
        raise ValueError(f'{what}: tables must be [{L}, {HEAD_DIM // 2}]')
    return cos, sin


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _residual_buffers(out):
    """(lse [B, heads, L] f32, out_f32) for a forward that writes the
    residuals: out_f32 is ``out`` itself in f32, a new f32 buffer for bf16."""
    B, L, A = out.shape
    lse = torch.empty(B, A // HEAD_DIM, L, dtype=torch.float32, device=out.device)
    return lse, (out if out.dtype == torch.float32 else torch.empty(
        B, L, A, dtype=torch.float32, device=out.device))


def _pointers(residuals, lse, out_f32, out):
    """The C entry's lse and out_f32 arguments (null: not written)."""
    if not residuals:
        return None, None
    return lse.data_ptr(), None if out_f32 is out else out_f32.data_ptr()


def _rotated_scratch(x: torch.Tensor, B: int, L: int, heads: int) -> torch.Tensor:
    """The mma.sync and FMA backwards' scratch: rotated q and k, [2, B,
    heads, L, 64] in x's type."""
    return torch.empty(2, B, heads, L, HEAD_DIM, dtype=x.dtype, device=x.device)


def _aligned(plan, *ts):
    """The tensors TMA reads on the Hopper path, each at a 16-byte aligned
    address (a misaligned one cloned); on the other paths as given."""
    if plan['path'] != 'wgmma':
        return ts
    return tuple(t.clone() if t.data_ptr() % 16 else t for t in ts)


def _bwd_tables(cos, sin, x, L, what, plan):
    """The backward's cos and sin tables, each 16-byte aligned on the Hopper
    path (one bulk copy each)."""
    return _aligned(plan, *_tables(cos, sin, x, L, what))


def rope_attention_qkv_forward(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                               scale: float, heads: int, residuals: bool = False,
                               plan: dict = None):
    """K1 on a CUDA tensor, or the plain version on a CPU one: [B, L,
    heads*64]; with ``residuals`` (out, out_f32, lse), the backward's
    residuals written beside the output (see ``rope_attention_reference``).
    ``plan`` (``rope_attention_qkv_plan``) defaults to the shape's own; a
    caller may pass another path's to compare the two."""
    global launches
    if qkv.device.type == 'cpu':
        return rope_attention_qkv_reference(qkv, cos, sin, scale, heads, residuals)
    _check_cuda(qkv, heads * 3 * HEAD_DIM, 'rope_attention_qkv')
    B, L, _ = qkv.shape
    plan = plan or rope_attention_qkv_plan(B, L, heads, qkv.dtype)
    cos, sin = _tables(cos, sin, qkv, L, 'rope_attention_qkv')
    qkv, = _aligned(plan, qkv.contiguous())
    out = torch.empty(B, L, heads * HEAD_DIM, dtype=qkv.dtype, device=qkv.device)
    lse, out_f32 = _residual_buffers(out) if residuals else (None, None)
    lib = _build.load('rope_attention', _SIGNATURES)
    ptrs = (qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
            *_pointers(residuals, lse, out_f32, out))
    with torch.cuda.device(qkv.device):
        if plan['path'] == 'wgmma':
            code = lib.hd_rope_attention_qkv_tma(*ptrs, B, L, heads, float(scale),
                                                 plan['c_array'], _stream(qkv))
        else:
            code = lib.hd_rope_attention_qkv(*ptrs, B, L, heads, HEAD_DIM, float(scale),
                                             _DTYPES[qkv.dtype], _stream(qkv))
    _build.check(code, 'rope_attention_qkv')
    launches += 1
    return (out, out_f32, lse) if residuals else out


def rope_attention_qkv_backward(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                                do: torch.Tensor, scale: float, heads: int, *,
                                out: torch.Tensor = None, lse: torch.Tensor = None,
                                plan: dict = None) -> torch.Tensor:
    """dqkv [B, L, heads*3*64] for the output gradient ``do`` [B, L,
    heads*64] (cast to qkv's type first, as ``_fused_qkv_bwd`` does): K3 on
    a CUDA tensor, the plain version on a CPU one. ``out`` (the forward's
    output before rounding, f32) and ``lse`` are the forward's residuals
    (``rope_attention_qkv_forward(..., residuals=True)``); when they are
    not given, this runs that forward first (K1, counted in ``launches``).
    On a CPU tensor the plain version recomputes the softmax as the TPU
    kernel does and needs no residuals. ``plan``
    (``rope_attention_bwd_plan``) defaults to the shape's own; a caller may
    pass another path's to compare the two."""
    global bwd_launches
    what = 'rope_attention_qkv_backward'
    if (out is None) != (lse is None):
        raise ValueError(f'{what}: give both out and lse, or neither')
    do = do.to(qkv.dtype)
    if qkv.device.type == 'cpu':
        return rope_attention_qkv_backward_reference(qkv, cos, sin, do, scale, heads)
    _check_cuda(qkv, heads * 3 * HEAD_DIM, what)
    B, L, _ = qkv.shape
    if do.shape != (B, L, heads * HEAD_DIM) or do.device != qkv.device:
        raise ValueError(f'{what}: do must be [{B}, {L}, {heads * HEAD_DIM}] on {qkv.device}')
    plan = plan or rope_attention_bwd_plan(B, L, heads, qkv.dtype)
    cos, sin = _bwd_tables(cos, sin, qkv, L, what, plan)
    qkv, do = _aligned(plan, qkv.contiguous(), do.contiguous())
    if out is None:
        _, out, lse = rope_attention_qkv_forward(qkv, cos, sin, scale, heads, residuals=True)
    out, lse = _check_residuals(out, lse, qkv, B, L, heads, what)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty(B, heads, L, dtype=torch.float32, device=qkv.device)
    lib = _build.load('rope_attention_bwd', _BWD_SIGNATURES)
    launched = ctypes.c_int(0)
    ptrs = (qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), do.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dqkv.data_ptr())
    rot = None if plan['path'] == 'wgmma' else _rotated_scratch(qkv, B, L, heads)
    with torch.cuda.device(qkv.device):
        if rot is None:   # the Hopper passes rotate q and k themselves
            code = lib.hd_rope_attention_qkv_bwd_tma(
                *ptrs, delta.data_ptr(), B, L, heads, float(scale), plan['c_array'],
                _stream(qkv), ctypes.addressof(launched))
        else:
            code = lib.hd_rope_attention_qkv_bwd(
                *ptrs, rot.data_ptr(), delta.data_ptr(), B, L, heads, HEAD_DIM, float(scale),
                _DTYPES[qkv.dtype], _stream(qkv), ctypes.addressof(launched))
    bwd_launches += launched.value
    _build.check(code, what)
    return dqkv


class RopeAttentionQKV(torch.autograd.Function):
    """K1 forward writing the residuals, K3 backward from them (the custom
    VJP of pallas_attention.py:320-337, which saves qkv alone). Saves qkv,
    the f32 output and lse: cos/sin are constants."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, scale, heads):
        out, out_f32, lse = rope_attention_qkv_forward(qkv, cos, sin, scale, heads,
                                                       residuals=True)
        ctx.save_for_backward(qkv, out_f32, lse)
        ctx.cos, ctx.sin, ctx.scale, ctx.heads = cos, sin, scale, heads
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out_f32, lse = ctx.saved_tensors
        dqkv = rope_attention_qkv_backward(qkv, ctx.cos, ctx.sin, do, ctx.scale, ctx.heads,
                                           out=out_f32, lse=lse)
        return dqkv, None, None, None, None


def rope_attention_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                       scale: float, heads: int) -> torch.Tensor:
    """RoPE attention on head-major merged qkv [B, L, heads*3*64] with
    [L, 32] f32 rotate-half tables; returns [B, L, heads*64]."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return RopeAttentionQKV.apply(qkv, cos, sin, scale, heads)
    return rope_attention_qkv_forward(qkv, cos, sin, scale, heads)


def tp_splits_heads(heads: int, width: int, mesh) -> bool:
    """Whether ``mesh`` splits attention over ``heads`` heads and a merged
    qkv of ``width`` columns by head group: tp > 1, ``heads`` divisible by
    tp and ``width`` by 3 * heads. Elsewhere the call is unsharded, as
    ``rope_attention_qkv_tp`` falls back in JAX."""
    tp = 1 if mesh is None else mesh.tp
    return tp > 1 and not heads % tp and not width % (3 * heads)


def rope_attention_qkv_tp(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                          scale: float, heads: int, mesh, width: int) -> torch.Tensor:
    """Tensor-parallel RoPE attention (pallas_attention.py:361-404): where
    ``tp_splits_heads(heads, width, mesh)``, ``qkv`` is this rank's
    contiguous block of the head-major merged projection's ``width``
    columns, [B, L, width / tp], which holds heads / tp whole heads, and
    this is ``rope_attention_qkv`` (K1, K3 in its backward) on them: [B, L,
    heads / tp * 64], the rank's columns of the output, which the
    row-split out projection contracts with one all-reduce. Elsewhere (tp
    == 1, heads % tp, width % (3 * heads)) ``qkv`` is the whole projection
    and the call is unsharded. No collective runs here."""
    if not tp_splits_heads(heads, width, mesh):
        return rope_attention_qkv(qkv, cos, sin, scale, heads)
    return rope_attention_qkv(qkv, cos, sin, scale, heads // mesh.tp)


def rope_attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cos: torch.Tensor, sin: torch.Tensor, scale: float, heads: int,
                           residuals: bool = False, plan: dict = None):
    """K5 on CUDA tensors, or the plain version on CPU ones: [B, L,
    heads*64]; with ``residuals`` (out, out_f32, lse), as K1's. ``plan``
    (``rope_attention_qkv_plan(..., layout='sep')``) defaults to the
    shape's own; a caller may pass another path's to compare the two."""
    global rope_launches
    what = 'rope_attention'
    if q.device.type == 'cpu':
        return rope_attention_reference(q, k, v, cos, sin, scale, heads, residuals)
    _check_same((q, k, v), what)
    _check_cuda(q, heads * HEAD_DIM, what)
    B, L, _ = q.shape
    plan = plan or rope_attention_qkv_plan(B, L, heads, q.dtype, layout='sep')
    cos, sin = _tables(cos, sin, q, L, what)
    q, k, v = _aligned(plan, q.contiguous(), k.contiguous(), v.contiguous())
    out = torch.empty_like(q)
    lse, out_f32 = _residual_buffers(out) if residuals else (None, None)
    lib = _build.load('rope_attention', _SIGNATURES)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            out.data_ptr(), *_pointers(residuals, lse, out_f32, out))
    with torch.cuda.device(q.device):
        if plan['path'] == 'wgmma':
            code = lib.hd_rope_attention_tma(*ptrs, B, L, heads, float(scale), plan['c_array'],
                                             _stream(q))
        else:
            code = lib.hd_rope_attention(*ptrs, B, L, heads, HEAD_DIM, float(scale),
                                         _DTYPES[q.dtype], _stream(q))
    _build.check(code, what)
    rope_launches += 1
    return (out, out_f32, lse) if residuals else out


def rope_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor, do: torch.Tensor,
                            scale: float, heads: int, *, out: torch.Tensor = None,
                            lse: torch.Tensor = None, plan: dict = None):
    """(dq, dk, dv), each [B, L, heads*64], for the output gradient ``do``
    (cast to q's type first, as ``_fused_bwd`` does): K6 on CUDA tensors,
    the plain version on CPU ones. ``out`` and ``lse`` are the forward's
    residuals (``rope_attention_forward(..., residuals=True)``); when they
    are not given, this runs that forward first (K5, counted in
    ``rope_launches``). On CPU tensors the plain version recomputes the
    softmax as the TPU kernel does and needs no residuals. ``plan``
    (``rope_attention_bwd_plan(..., layout='sep')``) defaults to the
    shape's own."""
    global rope_bwd_launches
    what = 'rope_attention_backward'
    if (out is None) != (lse is None):
        raise ValueError(f'{what}: give both out and lse, or neither')
    do = do.to(q.dtype)
    if q.device.type == 'cpu':
        return rope_attention_backward_reference(q, k, v, cos, sin, do, scale, heads)
    _check_same((q, k, v, do), what)
    _check_cuda(q, heads * HEAD_DIM, what)
    B, L, _ = q.shape
    plan = plan or rope_attention_bwd_plan(B, L, heads, q.dtype, layout='sep')
    cos, sin = _bwd_tables(cos, sin, q, L, what, plan)
    q, k, v, do = _aligned(plan, *(t.contiguous() for t in (q, k, v, do)))
    if out is None:
        _, out, lse = rope_attention_forward(q, k, v, cos, sin, scale, heads, residuals=True)
    out, lse = _check_residuals(out, lse, q, B, L, heads, what)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(B, heads, L, dtype=torch.float32, device=q.device)
    lib = _build.load('rope_attention_bwd', _BWD_SIGNATURES)
    launched = ctypes.c_int(0)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            do.data_ptr(), out.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr())
    rot = None if plan['path'] == 'wgmma' else _rotated_scratch(q, B, L, heads)
    with torch.cuda.device(q.device):
        if rot is None:   # the Hopper passes rotate q and k themselves
            code = lib.hd_rope_attention_bwd_tma(
                *ptrs, delta.data_ptr(), B, L, heads, float(scale), plan['c_array'], _stream(q),
                ctypes.addressof(launched))
        else:
            code = lib.hd_rope_attention_bwd(
                *ptrs, rot.data_ptr(), delta.data_ptr(), B, L, heads,
                HEAD_DIM, float(scale), _DTYPES[q.dtype], _stream(q), ctypes.addressof(launched))
    rope_bwd_launches += launched.value
    _build.check(code, what)
    return dq, dk, dv


class RopeAttention(torch.autograd.Function):
    """K5 forward writing the residuals, K6 backward from them (the custom
    VJP of pallas_attention.py:171-188, which saves q, k, v alone). Saves
    q, k, v, the f32 output and lse: cos/sin are constants."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, scale, heads):
        out, out_f32, lse = rope_attention_forward(q, k, v, cos, sin, scale, heads,
                                                   residuals=True)
        ctx.save_for_backward(q, k, v, out_f32, lse)
        ctx.cos, ctx.sin, ctx.scale, ctx.heads = cos, sin, scale, heads
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out_f32, lse = ctx.saved_tensors
        dq, dk, dv = rope_attention_backward(q, k, v, ctx.cos, ctx.sin, do, ctx.scale,
                                             ctx.heads, out=out_f32, lse=lse)
        return dq, dk, dv, None, None, None, None


def rope_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """RoPE(q, k) then softmax(q k^T * scale) v, head-blocked: q, k, v
    [B, L, heads*64] (the raw projection outputs), [L, 32] f32 rotate-half
    tables; returns [B, L, heads*64] in v's type."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RopeAttention.apply(q, k, v, cos, sin, scale, heads)
    return rope_attention_forward(q, k, v, cos, sin, scale, heads)


def _attention_kernel(q, k, v, scale, layout, plan):
    """K7 on q, k, v of one shape in ``layout`` ('blhd' [B, L, H, 64] or
    'bhld' [B, H, L, 64]), made contiguous; the output in the same layout.
    ``plan`` (``rope_attention_qkv_plan(..., layout=layout)``) defaults to
    the shape's own."""
    global attention_launches
    what = FWD_LAYOUTS[layout][0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f'{what}: forward only (no VJP, as in the JAX package); '
                           'use rope_attention in differentiated code')
    _check_same((q, k, v), what)
    _check_cuda(q, HEAD_DIM, what)
    if layout == 'blhd':
        B, L, H, D = q.shape
        strides = (L * H * D, H * D, D)
    else:
        B, H, L, D = q.shape
        strides = (H * L * D, D, L * D)
    plan = plan or rope_attention_qkv_plan(B, L, H, q.dtype, layout=layout)
    q, k, v = _aligned(plan, q.contiguous(), k.contiguous(), v.contiguous())
    out = torch.empty_like(q)
    lib = _build.load('rope_attention', _SIGNATURES)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    with torch.cuda.device(q.device):
        if plan['path'] == 'wgmma':
            code = lib.hd_attention_tma(*ptrs, B, L, H, int(layout == 'bhld'), float(scale),
                                        plan['c_array'], _stream(q))
        else:
            code = lib.hd_attention(*ptrs, B, L, H, HEAD_DIM, *strides, *strides, float(scale),
                                    _DTYPES[q.dtype], _stream(q))
    _build.check(code, what)
    attention_launches += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                    plan: dict = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over q, k, v [B, H, L, 64]; returns
    [B, H, L, 64] in v's type. Forward only: K7 on CUDA tensors, the plain
    version on CPU ones. ``plan`` (``rope_attention_qkv_plan(...,
    layout='bhld')``) defaults to the shape's own; a caller may pass another
    path's to compare the two."""
    if q.device.type == 'cpu':
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        return t(attention_reference(t(q), t(k), t(v), scale))
    return _attention_kernel(q, k, v, scale, 'bhld', plan)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
              plan: dict = None) -> torch.Tensor:
    """Attention over [B, L, H, 64] inputs (RoPE applied by the caller) ->
    [B, L, H, 64]. Forward only: K7 on CUDA tensors, reading this layout
    through its strides (the JAX package transposes to [B, H, L, D]; the
    result is the same), the plain version on CPU ones. ``plan`` as for
    ``fused_attention``, with layout 'blhd'."""
    if q.device.type == 'cpu':
        return attention_reference(q, k, v, scale)
    return _attention_kernel(q, k, v, scale, 'blhd', plan)


def attention_matmul_flops(B: int, L: int, heads: int, head_dim: int,
                           backward: bool = False) -> float:
    """Executed matrix-unit FLOPs of one fused RoPE-attention call, as the
    JAX package counts them (pallas_attention.py:500-515). Forward per
    head: 2 RoPE rotation products ([L,D]@[D,D]) + QK^T + PV. Backward per
    head: 4 rotations (q/k recompute + dq/dk inverse) + 5 [L,L,D] products
    (st recompute, dv, dp, dq, dk). ``backward=True`` returns the total of
    a forward and backward pass (the forward runs again under grad)."""
    rot = 2.0 * L * head_dim * head_dim
    big = 2.0 * L * L * head_dim
    fwd = B * heads * (2 * rot + 2 * big)
    if not backward:
        return fwd
    bwd = B * heads * (4 * rot + 5 * big)
    return fwd + bwd
