"""K2 and K4: the ByteNet residual block, forward and backward.

Counterpart of hudiff_tpu/ops/pallas_bytenet.py (``bytenet_block_fused``,
its TPU kernels ``_fwd_kernel`` and ``_bwd_kernel`` and the custom VJP
around them, :380-407). The CUDA kernels are ``csrc/bytenet_block.cu`` (K2:
one call launches three GEMMs; the first applies LayerNorm 1 + activation
to x's rows as they land, and the first two finish the next LayerNorm in
their epilogues, as thread-block clusters spanning a row tile's columns,
writing act(LN2 p) and act(LN3 q) for the next GEMM; in bf16 with widths
that are multiples of 128 on Hopper's TMA + wgmma, on 64-row tiles at the
sampling batches and 128-row tiles at the training batches, the second
and third GEMM starting under the previous one's tail, otherwise on the
earlier cp.async + mma.sync core, chosen by ``bytenet_block_plan`` from the
shape) and ``csrc/bytenet_block_bwd.cu`` (K4: five launches, three
data-gradient GEMMs with the LayerNorm backward in their epilogues, one
grouped weight-gradient GEMM and one fixed-order reduction; in bf16 with
widths that are multiples of 128 on TMA + wgmma, the data GEMMs as
clusters over a row tile's columns and the weight gradients on wgmma's
transpose-A bit, otherwise on the cp.async + mma.sync core, chosen by
``bytenet_block_backward_plan`` from the shape); the older designs run on
``csrc/gemm_tiles.cuh``, the Hopper ones on ``csrc/wgmma_tiles.cuh``; the
sources' headers say what bounds them on an H100 and how the designs
answer that.

Parameters: ``w1`` [H, D] and ``w2`` [D, H] as ``nn.Linear`` weights,
``wc`` [H, K, H] (out, tap, in: ``ops/bytenet.py::DilatedConv``); the
LayerNorm scales and biases and the three biases are f32.

``bytenet_block`` routes by the tensor's device alone: a CPU tensor takes
the plain versions, a CUDA tensor launches the kernels (or raises). When a
gradient is needed it goes through ``ByteNetBlockFn``, whose forward is K2
keeping p and q (the pre-LayerNorm Dense and conv outputs, in x's type), the
three LayerNorms' row statistics and the weights in x's type it gave K2, and
whose backward is K4 on those, returning dx and the 12 parameter gradients
in f32.
Otherwise it calls K2 alone, as the sampler does. ``launches`` and
``bwd_launches`` (``COUNTERS``) count the CUDA kernels K2's and K4's C
entries report; under a CUDA graph the graph sampler counts replays
(``ops/fused_attention.py`` says how).
``block_matmul_flops`` is a call's FLOP count (utils/flops.py).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .norm import LN_EPS, activation, layer_norm

launches = 0
bwd_launches = 0
COUNTERS = ('launches', 'bwd_launches')

_SIGNATURES = {
    'hd_bytenet_block_fwd': [ctypes.c_void_p] * 19 + [ctypes.c_int] * 8
                            + [ctypes.c_void_p, ctypes.c_void_p],
    'hd_bytenet_block_fwd_tma': [ctypes.c_void_p] * 19 + [ctypes.c_int] * 7
                                + [ctypes.c_void_p] * 3,
    'hd_bytenet_block_fwd_occupancy': [ctypes.c_void_p] * 2,
}
_BWD_SIGNATURES = {
    'hd_bytenet_block_bwd': [ctypes.c_void_p] * 31 + [ctypes.c_int] * 8
                            + [ctypes.c_void_p, ctypes.c_void_p],
    'hd_bytenet_block_bwd_workspace': [ctypes.c_int] * 6,
    'hd_bytenet_block_bwd_tma': [ctypes.c_void_p] * 31 + [ctypes.c_int] * 7
                                + [ctypes.c_void_p] * 3,
    'hd_wgmma_trans_a_probe': [ctypes.c_void_p] * 4,
    'hd_bytenet_block_bwd_occupancy': [ctypes.c_void_p] * 2,
}
_BWD_RESTYPES = {'hd_bytenet_block_bwd_workspace': ctypes.c_longlong}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {'relu': 0, 'gelu': 1}

# K2's launches on the H100 (csrc/bytenet_block.cu). Two Hopper designs
# (bf16, D and H multiples of 128), both a producer warp and two consumer
# warpgroups. The 64-row design ('wgmma') takes 64 x bn tiles (bn 128, or
# 64 for launches of few tiles: K2_NARROW_TILES), its groups splitting the
# chunks; a stage of its ring is a 64 x 64 A box (8 KB) and bn weight rows
# of 64 channels, then come the mbarriers, [4][64] float2 of row
# statistics, F1's LayerNorm g and b (1024 f32 each), the tile's bias and
# next LayerNorm's g and b (bn f32 each) and 1 KB of alignment: with eight
# stages one block holds an SM, with four two share one. The 128-row
# design ('wgmma128', K4's data-GEMM block) takes 128 x 128 tiles, each
# group 64 rows over every chunk, or 128 x 256 tiles with four groups where
# N is a multiple of 256; a stage is the 128 A rows and the tile's weight
# rows of 64 channels (32 or 48 KB), then the mbarriers (256 bytes),
# [2][128] float2 of row values, the same parameters: three stages of 128
# columns let two blocks share an SM, six hold one; four of 256 hold one.
# F2 and F3 are programmatic dependent launches: each starts under the
# launch before it, sets up, asks for its first weights and waits for it
# before reading or writing anything else (F1 as well read 16% slower at
# 768/384, B = 64, L = 152, and gained under 1 us elsewhere).
# The plan picks the design by shape where it read fastest on an H100
# (``_k2_design``); mma.sync keeps the demos' widths (and runs on request),
# FMA f32.
H100_SMS = 132
MAX_SMEM = 232448
MAX_CLUSTER = 8
K2_TMA_BM, K2_TMA_BN, K2_WIDE_BM = 64, 128, 128
K2_TMA_THREADS = 9 * 32          # a producer warp and two consumer warpgroups
K2_WIDE_THREADS_256 = 17 * 32    # 256-column tiles: four consumer warpgroups
K2_TMA_STAGES = (4, 8)
K2_WIDE_STAGES = (3, 6)   # 128-column tiles: two blocks an SM, or one
K2_WIDE_STAGES_256 = 4    # 256-column tiles: one block an SM
K2_PLAN_LEN = 20
K2_PATHS = ('wgmma', 'wgmma128', 'mma_sync', 'fma')
K2_HOPPER = ('wgmma', 'wgmma128')


def k2_tma_smem(stages: int, bn: int = K2_TMA_BN) -> int:
    """Shared memory of a 64-row Hopper K2 block: a ring of ``stages``, bn columns."""
    return stages * (64 + bn) * 128 + 2 * stages * 8 + 4 * 64 * 8 + (2 * 1024 + 3 * bn) * 4 + 1024


def k2_wide_smem(stages: int, bn: int = K2_TMA_BN) -> int:
    """Shared memory of a 128-row Hopper K2 block: a ring of ``stages``, bn columns."""
    return stages * (128 + bn) * 128 + 256 + 2 * 128 * 8 + (2 * 1024 + 3 * bn) * 4 + 1024


# The design each bf16 shape takes (M = B*L rows), where
# bytenet_fwd_sweep --shapes paths read it fastest on an H100: the 64-row
# design up to K2_WIDE_MIN_ROWS rows (B <= 16 at L = 152; the 256/128
# tower up to K2_WIDE_MIN_ROWS_H128, B <= 32), the 128-row one past them
K2_WIDE_MIN_ROWS = 4096
K2_WIDE_MIN_ROWS_H128 = 8192
# the 64-row design's F1, F2 and F3 of at most this many 64 x 128 tiles
# take 64-column tiles, where those read faster on an H100 (B = 16: F1 of
# the 256/128 tower, F2 up to 512/256, F3 up to 768/384; every launch at
# B = 1)
K2_NARROW_TILES = (38, 76, 228)


def _k2_design(M: int, D: int, H: int) -> str:
    """The bf16 design of a shape whose widths are multiples of 128."""
    return 'wgmma' if M <= (K2_WIDE_MIN_ROWS_H128 if H == 128 else K2_WIDE_MIN_ROWS) \
        else 'wgmma128'


def _pr5_launch(M: int, N: int, cluster: bool, dtype) -> dict:
    """One GEMM of the cp.async + mma.sync core (``big_tiles`` and ``FwdTile`` in
    csrc/bytenet_block.cu), for the record: 128 x 128 tiles where they give
    two blocks an SM or a 64-column cluster would pass 8 blocks, else 64 x 64."""
    big = -(-M // 128) * -(-N // 128) >= 2 * H100_SMS or (cluster and N > 64 * MAX_CLUSTER)
    bm = bn = 128 if big else 64
    bk = 128 // (4 if dtype is torch.float32 else 2)
    es = 4 if dtype is torch.float32 else 2
    grid = (-(-M // bm), -(-N // bn), 1)
    return {'grid': grid, 'cluster': (1, grid[1] if cluster else 1, 1), 'threads': 256,
            'smem_bytes': 3 * (bm + bn) * bk * es + 6 * bm * 8, 'bn': bn}


@functools.lru_cache(maxsize=None)
def bytenet_block_plan(B: int, L: int, D: int, H: int, K: int, dilation: int, dtype,
                       path: str = None, bn: int = None, pdl: bool = None) -> dict:
    """K2's three launches (F1: p and act(LN2 p) from x; F2: the dilated
    conv, q and act(LN3 q); F3: y) for x [B, L, D] of ``dtype``, hidden H,
    K taps, on an H100, from the shape alone. ``path``: the Hopper designs
    (bf16, D and H multiples of 128) 'wgmma' (64-row tiles) and 'wgmma128'
    (128-row tiles), the one ``_k2_design`` names for the shape, else the
    earlier 'mma_sync' (bf16) or 'fma' (f32). Each launch: ``grid``,
    ``cluster``, ``threads``, ``smem_bytes`` and the column tile ``bn``; on
    a Hopper design (grid: column tiles, row tiles of ``bm`` of the B*L
    rows, 1) also the ring's ``stages``, ``pdl`` (launched to start under
    the previous launch's tail: F2 and F3), the A rows' and the weights'
    tensor maps and ``array``, the K2_PLAN_LEN values a launch the C entry
    takes (``c_array`` as ctypes; plans are cached by shape).
    ``path`` names another design for comparison, where its kernel takes
    the shape; ``bn`` the column tiles of all three launches, or of each
    (a tuple of three, None for the plan's own): 64 or 128 in the 64-row
    design, 128 or 256 in the 128-row one; ``pdl=False``
    launches without the overlap; what no kernel takes raises."""
    if dtype not in _DTYPES:
        raise TypeError(f'bytenet_block: dtype {dtype} not supported')
    if (B <= 0 or L <= 0 or D <= 0 or H <= 0 or D % 32 or H % 32 or max(D, H) > 1024
            or K <= 0 or K % 2 == 0 or dilation <= 0):
        raise ValueError(f'bytenet_block: unsupported shape B={B} L={L} D={D} H={H} K={K} '
                         f'dilation={dilation} (D, H multiples of 32 up to 1024, K odd)')
    bf16 = dtype is torch.bfloat16
    M = B * L
    takes = bf16 and D % K2_TMA_BN == 0 and H % K2_TMA_BN == 0 and M <= 1 << 30
    path = path or (_k2_design(M, D, H) if takes else 'mma_sync' if bf16 else 'fma')
    if path not in K2_PATHS or (path in K2_HOPPER and not takes) \
            or (path == 'mma_sync' and not bf16) or (path == 'fma' and bf16):
        raise ValueError(f'bytenet_block: no {path!r} path for {dtype} at B={B} L={L} '
                         f'D={D} H={H}')
    gemms = ((D, H, 1, True), (H, H, K, True), (H, D, 1, False))   # (C, N, taps, next LN)
    if path not in K2_HOPPER:
        if bn is not None or pdl is not None:
            raise ValueError(f'bytenet_block: the {path!r} design picks its own tiles')
        return {'path': path, 'launches': [_pr5_launch(M, N, ln, dtype)
                                           for _, N, _, ln in gemms]}
    wide = path == 'wgmma128'
    tiles = bn if isinstance(bn, tuple) else (bn,) * 3
    if len(tiles) != 3 or not set(tiles) <= ({None, K2_TMA_BN, 256} if wide
                                             else {None, 64, K2_TMA_BN}):
        raise ValueError(f'bytenet_block: no {bn}-column tiles in the {path!r} design')
    bm = K2_WIDE_BM if wide else K2_TMA_BM
    launches = []
    for i, (C, N, taps, ln) in enumerate(gemms):
        asked = tiles[i]
        if wide:   # 256 columns for F1 where N allows (x rewritten once a row tile)
            cols = asked or (256 if i == 0 and N % 256 == 0 else K2_TMA_BN)
        else:      # 64 where a launch has few tiles
            narrow = N // 128 * -(-M // bm) <= K2_NARROW_TILES[i]
            cols = asked or (64 if narrow else K2_TMA_BN)
        if N % cols or (ln and N // cols > MAX_CLUSTER):   # a cluster spans a row tile's columns
            if asked:
                raise ValueError(f'bytenet_block: {N} columns in tiles of {cols} (a cluster '
                                 f'of at most {MAX_CLUSTER})')
            cols = K2_TMA_BN
        grid = (N // cols, -(-M // bm), 1)
        blocks = grid[0] * grid[1]
        if wide:   # 128 columns: six stages where the blocks fit the SMs one each, else
            # three, two an SM; 256 columns: four, one an SM
            stages = K2_WIDE_STAGES_256 if cols == 256 else K2_WIDE_STAGES[blocks <= H100_SMS]
            smem = k2_wide_smem(stages, cols)
        else:      # eight for F1 (one block an SM) and where the blocks fit the SMs, else four
            stages = K2_TMA_STAGES[(taps == 1 and ln) or blocks <= H100_SMS]
            smem = k2_tma_smem(stages, cols)
        a_map = {'dims': (C, M), 'strides': (C * 2,), 'box': (64, bm)}
        w_map = {'dims': (taps * C, N), 'strides': (taps * C * 2,), 'box': (64, cols)}
        launch = {'grid': grid, 'cluster': (grid[0] if ln else 1, 1, 1), 'bm': bm,
                  'threads': K2_WIDE_THREADS_256 if cols == 256 else K2_TMA_THREADS,
                  'smem_bytes': smem, 'bn': cols, 'stages': stages,
                  'pdl': i > 0 and pdl is not False, 'chunks': taps * C // 64,
                  'a_map': a_map, 'w_map': w_map}
        launch['array'] = (*grid, launch['cluster'][0], launch['threads'], smem, bm, cols,
                           stages, int(launch['pdl']), *a_map['dims'], *a_map['strides'],
                           *a_map['box'], *w_map['dims'], *w_map['strides'], *w_map['box'])
        launches.append(launch)
    array = sum((ln['array'] for ln in launches), ())
    return {'path': path, 'launches': launches, 'array': array,
            'c_array': (ctypes.c_longlong * len(array))(*array)}


# K4's launches on the H100 (csrc/bytenet_block_bwd.cu). The Hopper path
# (bf16, D and H multiples of 128) runs its three data GEMMs on 128 x 128
# tiles of the B*L rows and N columns: a producer warp and two consumer
# warpgroups of 64 rows each; a stage is the A rows (two 64 x 64 boxes)
# and the weights' 64 rows (two 64-column boxes), 32 KB (after the
# products: dh in f32 and the z tile); then come the mbarriers (256 bytes),
# three [128] float2 of row values, the tile's g and b (128 f32 each) and
# 1 KB of alignment: three stages, two blocks an SM. A cluster spans a row
# tile's N / 128 column tiles. The weight-gradient launch's blocks are 128
# x 128 tiles of one split of the rows, a stage two 64-column boxes of each
# operand (32 KB): three stages let two blocks share an SM, six hold one.
# The mma.sync and FMA designs keep the other shapes.
K4_TMA_BM, K4_TMA_BN = 128, 128
K4_TMA_THREADS = 9 * 32
K4_BOX = 64 * 128
K4_DATA_STAGES = 3
K4_WGRAD_STAGES = (3, 6)
K4_WGRAD_TARGET = 4 * H100_SMS    # weight-gradient blocks a call aims at ...
K4_WGRAD_MIN_ROWS = 512           # ... with at least this many rows a split (mma.sync)
K4_TMA_MIN_SPLIT_ROWS = 2048      # ... (Hopper: fewer partials; read faster on an H100)
# The 256/128 tower's data GEMMs have one 128-column tile: up to this many
# rows (B <= 32 at L = 152) the Hopper design left most SMs idle and read
# 5-6% slower than mma.sync on an H100; the plan keeps mma.sync there
K4_TMA_MIN_ROWS_H128 = 8192
K4_SUM_BLOCKS = 2 * H100_SMS
K4_SUM_JOBS = 12
K4_PLAN_LEN = 88
K4_PATHS = ('wgmma', 'mma_sync', 'fma')


def k4_data_smem(stages: int) -> int:
    """Shared memory of a Hopper K4 data-GEMM block with a ring of ``stages``."""
    return stages * 4 * K4_BOX + 256 + 3 * 128 * 8 + 2 * 128 * 4 + 1024


def k4_wgrad_smem(stages: int) -> int:
    """Shared memory of a Hopper K4 weight-gradient block."""
    return stages * 4 * K4_BOX + 256 + 1024


def _wgrad_tiles(P: int, Q: int) -> int:
    return -(-P // 128) * -(-Q // 128)


def _split_rows(M: int, splits: int) -> int:
    """Rows of a split, a multiple of 64 (``split_rows`` in the source)."""
    return -(-(-(-M // splits)) // 64) * 64


def _k4_workspace(M: int, D: int, H: int, K: int, nb: int, splits: int) -> int:
    """Bytes of the Hopper design's workspace (``layout_of``): dq, dp, e, bb
    [M, H] and a [M, D] bf16, the column partials [3][nb][H] twice and
    [3][nb][D], the splits' f32 partials of dW2, dWc, dW1; 256-byte aligned."""
    parts = (M * H * 2, M * H * 2, M * H * 2, M * H * 2, M * D * 2, 3 * nb * H * 4,
             3 * nb * H * 4, 3 * nb * D * 4, splits * D * H * 4, splits * H * K * H * 4,
             splits * H * D * 4)
    return sum(-(-b // 256) * 256 for b in parts)


@functools.lru_cache(maxsize=None)
def bytenet_block_backward_plan(B: int, L: int, D: int, H: int, K: int, dilation: int, dtype,
                                path: str = None, splits: int = None) -> dict:
    """K4's five launches for x [B, L, D] of ``dtype``, hidden H, K taps,
    on an H100, from the shape alone. ``path`` 'wgmma' (TMA + wgmma: bf16,
    D and H multiples of 128 up to 1024, except H = 128 up to
    K4_TMA_MIN_ROWS_H128 rows, where mma.sync read faster), else the earlier
    'mma_sync' (bf16) or 'fma' (f32), which keep no plan beyond their name
    (the source lays them out). For 'wgmma': the three data GEMMs (de, dbb, da: ``grid``
    column tiles x 64-row tiles, ``cluster`` a row tile's column tiles,
    ``threads``, ``smem_bytes``, ``stages``), the weight-gradient launch
    (``blocks``: 128 x 128 tiles of dW2, dWc, dW1 times ``splits`` of the
    rows, ``chunk`` rows each), the sum, the ``tensor_maps`` of dy, w2, q,
    dq, wc, p, dp, w1, x, e, bb, a (2-D, 64 x 64 boxes, 128-byte swizzle),
    ``workspace_bytes`` and ``array``, the K4_PLAN_LEN values the C entry
    takes (``c_array`` as ctypes; plans are cached by shape). ``path`` names
    another design for comparison where its kernel takes the shape;
    ``splits`` another split of the rows; what no kernel takes raises."""
    if dtype not in _DTYPES:
        raise TypeError(f'bytenet_block_backward: dtype {dtype} not supported')
    if (B <= 0 or L <= 0 or D <= 0 or H <= 0 or D % 32 or H % 32 or max(D, H) > 1024
            or K <= 0 or K % 2 == 0 or dilation <= 0 or B * L > (1 << 30) // D):
        raise ValueError(f'bytenet_block_backward: unsupported shape B={B} L={L} D={D} H={H} '
                         f'K={K} dilation={dilation} (D, H multiples of 32 up to 1024, K odd)')
    bf16 = dtype is torch.bfloat16
    takes = bf16 and D % K4_TMA_BN == 0 and H % K4_TMA_BN == 0
    faster = takes and (H > 128 or B * L > K4_TMA_MIN_ROWS_H128)
    path = path or ('wgmma' if faster else 'mma_sync' if bf16 else 'fma')
    if path not in K4_PATHS or (path == 'wgmma' and not takes) \
            or (path == 'mma_sync' and not bf16) or (path == 'fma' and bf16):
        raise ValueError(f'bytenet_block_backward: no {path!r} path for {dtype} at B={B} '
                         f'L={L} D={D} H={H}')
    if path != 'wgmma':
        if splits is not None:
            raise ValueError(f'bytenet_block_backward: the {path!r} design picks its own splits')
        return {'path': path}
    M = B * L
    rows = -(-M // K4_TMA_BM)
    tiles = _wgrad_tiles(D, H) + _wgrad_tiles(H, K * H) + _wgrad_tiles(H, D)
    if splits is None:
        splits = min(max(-(-K4_WGRAD_TARGET // tiles), 1), -(-M // K4_TMA_MIN_SPLIT_ROWS))
    if not 1 <= splits <= -(-M // 64):
        raise ValueError(f'bytenet_block_backward: {splits} splits of {M} rows')
    chunk = _split_rows(M, splits)
    splits = -(-M // chunk)
    data = []
    for N, C, taps in ((H, D, 1), (H, H, K), (D, H, 1)):   # de, dbb, da
        grid = (N // K4_TMA_BN, rows, 1)
        data.append({'grid': grid, 'cluster': (grid[0], 1, 1), 'threads': K4_TMA_THREADS,
                     'smem_bytes': k4_data_smem(K4_DATA_STAGES), 'stages': K4_DATA_STAGES,
                     'chunks': taps * C // 64})
    blocks = tiles * splits
    wstages = K4_WGRAD_STAGES[blocks <= H100_SMS]
    wgrad = {'blocks': blocks, 'threads': K4_TMA_THREADS, 'smem_bytes': k4_wgrad_smem(wstages),
             'stages': wstages, 'splits': splits, 'chunk': chunk}
    widest = max(H * K * H, D * H)
    sum_launch = {'blocks': min(-(-widest // 256), K4_SUM_BLOCKS), 'jobs': K4_SUM_JOBS,
                  'threads': 256}
    shapes = {'dy': (D, M), 'w2': (H, D), 'q': (H, M), 'dq': (H, M), 'wc': (K * H, H),
              'p': (H, M), 'dp': (H, M), 'w1': (D, H), 'x': (D, M), 'e': (H, M), 'bb': (H, M),
              'a': (D, M)}
    maps = {k: {'dims': v, 'strides': (v[0] * 2,), 'box': (64, 64), 'swizzle': 128}
            for k, v in shapes.items()}
    ws = _k4_workspace(M, D, H, K, rows, splits)
    array = (ws, splits, chunk,
             *(v for ln in data for v in (*ln['grid'][:2], ln['cluster'][0], ln['threads'],
                                          ln['smem_bytes'], ln['stages'])),
             blocks, K4_TMA_THREADS, wgrad['smem_bytes'], wstages,
             sum_launch['blocks'], K4_SUM_JOBS, 256,
             *(v for m in maps.values() for v in (*m['dims'], *m['strides'], *m['box'])))
    return {'path': 'wgmma', 'data': data, 'wgrad': wgrad, 'sum': sum_launch,
            'tensor_maps': maps, 'workspace_bytes': ws, 'array': array,
            'c_array': (ctypes.c_longlong * len(array))(*array)}


def _plain_p(x, g1, b1, w1, c1, activation_name: str):
    """The plain forward's first stage: p = cd(act(LN1 x) W1^T + c1)."""
    cd = x.dtype
    a = activation(layer_norm(x, g1, b1), activation_name).to(cd)
    return (a.float() @ w1.to(cd).float().t() + c1.float()).to(cd)


def _plain_q(p, g2, b2, wc, cc, dilation: int, activation_name: str):
    """The second: q = cd(conv(bb) + cc), bb = cd(act(LN2 p)), zero outside
    [0, L)."""
    cd = p.dtype
    bb = activation(layer_norm(p, g2, b2), activation_name).to(cd)
    pad = (wc.shape[1] - 1) // 2 * dilation
    return F.conv1d(bb.float().transpose(1, 2), wc.to(cd).float().permute(0, 2, 1), cc.float(),
                    padding=pad, dilation=dilation).transpose(1, 2).to(cd)


def _plain_y(x, q, g3, b3, w2, c2, activation_name: str):
    """The third: y = cd(x + e W2^T + c2), e = cd(act(LN3 q))."""
    cd = x.dtype
    e = activation(layer_norm(q, g3, b3), activation_name).to(cd)
    return (x.float() + (e.float() @ w2.to(cd).float().t() + c2.float())).to(cd)


def _reference_parts(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2, *,
                     dilation: int, activation_name: str):
    """(y, p, q) of the plain forward, stage by stage."""
    p = _plain_p(x, g1, b1, w1, c1, activation_name)
    q = _plain_q(p, g2, b2, wc, cc, dilation, activation_name)
    return _plain_y(x, q, g3, b3, w2, c2, activation_name), p, q


def bytenet_block_reference(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2,
                            *, dilation: int, activation_name: str) -> torch.Tensor:
    """Plain version of K2: LN(eps 1e-6) -> act -> matmul -> LN -> act ->
    dilated conv -> LN -> act -> matmul, plus x. Matmul and conv inputs are
    in x's type with f32 accumulation; p, q and y are rounded to x's type
    where the TPU kernel rounds them (ops/bytenet.py:144-155,
    pallas_bytenet.py:162-184)."""
    return _reference_parts(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2,
                            dilation=dilation, activation_name=activation_name)[0]


def _ln_parts(zf, g, b, st=None):
    """f32 LayerNorm with the fast variance: (affine output, normalized,
    1/sigma), as pallas_bytenet.py::_ln_parts (the variance clamped at 0, as
    the port's forward does); ``st`` [..., 2]: the rows' (mean, 1/sigma)
    given instead."""
    if st is None:
        mu = zf.mean(dim=-1, keepdim=True)
        var = (zf * zf).mean(dim=-1, keepdim=True) - mu * mu
        inv = torch.rsqrt(var.clamp_min(0.0) + LN_EPS)
    else:
        mu, inv = st[..., :1], st[..., 1:]
    n = (zf - mu) * inv
    return n * g.float() + b.float(), n, inv


def _ln_bwd(dn, n, inv):
    """dL/dz for n = normalize(z): (dn - mean(dn) - n mean(dn n)) / sigma."""
    m1 = dn.mean(dim=-1, keepdim=True)
    m2 = (dn * n).mean(dim=-1, keepdim=True)
    return (dn - m1 - n * m2) * inv


def _dact(u, name: str):
    """ReLU: u > 0; GELU: exact erf, cdf + u pdf."""
    if name == 'relu':
        return (u > 0).float()
    cdf = 0.5 * (1.0 + torch.erf(u * 0.7071067811865476))
    return cdf + u * torch.exp(-0.5 * u * u) * 0.3989422804014327


def _shift(t, s: int):
    """Rows l of [B, L, C] -> t[:, l + s], zero where l + s is outside [0, L)."""
    out = torch.zeros_like(t)
    L = t.shape[1]
    if abs(s) >= L:
        return out
    if s >= 0:
        out[:, :L - s] = t[:, s:]
    else:
        out[:, -s:] = t[:, :L + s]
    return out


def bytenet_block_backward_reference(x, p, q, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2,
                                     c2, dy, *, dilation: int, activation_name: str,
                                     stats=None):
    """Plain version of K4: (dx, dg1, db1, dw1, dc1, dg2, db2, dwc, dcc, dg3,
    db3, dw2, dc2) from the saved x, p, q, by explicit formulas following
    pallas_bytenet.py::_bwd_kernel (:203-273) line by line, with its
    rounding points: a, bb, e, dq and dp in x's type (cd), every product of
    cd values accumulated in f32, dx rounded to cd, the parameter gradients
    f32 in the port's layouts. ``stats`` [3, B, L, 2]: the LayerNorm
    statistics of x, p and q rows that K2 writes (the residual-taking
    variant, K4's arithmetic when given them), else taken here."""
    cd = x.dtype
    act = lambda t: activation(t, activation_name)  # noqa: E731
    dact = lambda t: _dact(t, activation_name)  # noqa: E731
    rnd = lambda t: t.to(cd).float()  # noqa: E731
    w1c, wcc, w2c = (rnd(w) for w in (w1, wc, w2))
    dyf = rnd(dy)
    st = (None,) * 3 if stats is None else stats.float()
    uh, un, inv1 = _ln_parts(x.float(), g1, b1, st[0])
    a = rnd(act(uh))
    vh, vn, inv2 = _ln_parts(p.float(), g2, b2, st[1])
    bb = rnd(act(vh))
    wh, wn, inv3 = _ln_parts(q.float(), g3, b3, st[2])
    e = rnd(act(wh))
    rows = (0, 1)

    # Dense_1 (w2): y = x + e w2^T + c2
    de = dyf @ w2c
    dw2 = torch.einsum('bld,blh->dh', dyf, e)
    dc2 = dyf.sum(rows)
    # LayerNorm_2 (g3, b3)
    dwh = de * dact(wh)
    dg3, db3 = (dwh * wn).sum(rows), dwh.sum(rows)
    dq = _ln_bwd(dwh * g3.float(), wn, inv3)
    dcc = dq.sum(rows)
    dqc = rnd(dq)
    # dilated conv: data grad reads dq shifted the opposite way per tap;
    # weight grad per tap = dq^T shifted bb
    K = wc.shape[1]
    dbb = torch.zeros_like(bb)
    dwc = torch.empty(wc.shape, dtype=torch.float32, device=x.device)
    for t in range(K):
        s = (t - (K - 1) // 2) * dilation
        dbb = dbb + _shift(dqc, -s) @ wcc[:, t, :]
        dwc[:, t, :] = torch.einsum('blo,bli->oi', dqc, _shift(bb, s))
    # LayerNorm_1 (g2, b2) + Dense_0 (w1)
    dvh = dbb * dact(vh)
    dg2, db2 = (dvh * vn).sum(rows), dvh.sum(rows)
    dp = _ln_bwd(dvh * g2.float(), vn, inv2)
    dc1 = dp.sum(rows)
    dpc = rnd(dp)
    da = dpc @ w1c
    dw1 = torch.einsum('blh,bld->hd', dpc, a)
    # LayerNorm_0 (g1, b1) + residual
    duh = da * dact(uh)
    dg1, db1 = (duh * un).sum(rows), duh.sum(rows)
    dx = (dyf + _ln_bwd(duh * g1.float(), un, inv1)).to(cd)
    return dx, dg1, db1, dw1, dc1, dg2, db2, dwc, dcc, dg3, db3, dw2, dc2


def _check(x, w1, wc, w2, activation_name: str, what: str):
    if x.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {x.device}')
    if x.dtype not in _DTYPES:
        raise TypeError(f'{what}: dtype {x.dtype} not supported')
    if activation_name not in _ACTS:
        raise ValueError(f'{what}: unknown activation {activation_name!r}')
    B, L, D = x.shape
    H, K = w1.shape[0], wc.shape[1]
    if (w1.shape != (H, D) or wc.shape != (H, K, H) or w2.shape != (D, H)
            or D % 32 or H % 32 or max(D, H) > 1024 or K % 2 == 0):
        raise ValueError(f'{what}: unsupported shapes x {tuple(x.shape)}, '
                         f'w1 {tuple(w1.shape)}, wc {tuple(wc.shape)}, '
                         f'w2 {tuple(w2.shape)} (D, H multiples of 32 up to 1024, K odd)')
    return B, L, D, H, K


def _ready(t, dev, dtype):
    """``t`` on ``dev`` in ``dtype``, contiguous; no copy when it already is."""
    ok = t.dtype is dtype and t.get_device() == dev.index and t.is_contiguous()
    return t if ok else t.to(device=dev, dtype=dtype).contiguous()


def _on(dev):
    """What a launch on ``dev`` needs around it: nothing when ``dev`` is the
    current device (the calls that take the small blocks are host-bound)."""
    return (contextlib.nullcontext() if torch.cuda.current_device() == dev.index
            else torch.cuda.device(dev))


_WEIGHTS = (2, 6, 10)   # w1, wc, w2 among the 12 parameters


def _prepared(params, dev, cd):
    """The 12 parameters as the kernels take them, on ``dev`` and
    contiguous: the weights in the activation type ``cd``, the LayerNorm
    parameters and biases in f32 (no copy where one already is)."""
    return tuple(_ready(t, dev, cd if i in _WEIGHTS else torch.float32)
                 for i, t in enumerate(params))


def _aligned(t):
    """``t``, or a copy of it where its address is not 16-byte aligned (TMA)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(x, params, dilation: int, activation_name: str, keep: bool, plan: dict = None):
    """K2 on a CUDA tensor, the plain version on a CPU one: (y, p, q, stats)
    with p, q and K2's LayerNorm statistics of x, p, q rows ([3, B, L, 2]
    f32, the backward's residuals; None from the plain version) None unless
    ``keep``. ``plan`` (``bytenet_block_plan``) defaults to the shape's own;
    a caller may pass another path's to compare the two."""
    global launches
    if x.device.type == 'cpu':
        y, p, q = _reference_parts(x, *params, dilation=dilation,
                                   activation_name=activation_name)
        return (y, p, q, None) if keep else (y, None, None, None)
    B, L, D, H, K = _check(x, params[2], params[6], params[10], activation_name,
                           'bytenet_block')
    plan = plan or bytenet_block_plan(B, L, D, H, K, dilation, x.dtype)
    dev, cd = x.device, x.dtype
    params = _prepared(params, dev, cd)
    x = x.contiguous()
    tma = plan['path'] in K2_HOPPER
    if tma:
        x = _aligned(x)
        params = tuple(_aligned(t) if i in _WEIGHTS else t for i, t in enumerate(params))
    y = torch.empty_like(x)
    p = torch.empty(B, L, H, dtype=cd, device=dev) if keep else None
    q = torch.empty(B, L, H, dtype=cd, device=dev) if keep else None
    stats = torch.empty(3, B, L, 2, dtype=torch.float32, device=dev) if keep else None
    # scratch: bb = act(LN2 p) and e = act(LN3 q), each written by the GEMM
    # before the one that reads it
    scratch = torch.empty(2, B, L, H, dtype=cd, device=dev)
    lib = _build.load('bytenet_block', _SIGNATURES)
    launched = ctypes.c_int(0)
    ptrs = (x.data_ptr(), *(t.data_ptr() for t in params),
            *((t.data_ptr() if keep else None) for t in (p, q)), y.data_ptr(),
            scratch[0].data_ptr(), scratch[1].data_ptr(), stats.data_ptr() if keep else None)
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tma:
            code = lib.hd_bytenet_block_fwd_tma(
                *ptrs, B, L, D, H, K, int(dilation), _ACTS[activation_name], plan['c_array'],
                stream, ctypes.addressof(launched))
        else:
            code = lib.hd_bytenet_block_fwd(
                *ptrs, B, L, D, H, K, int(dilation), _ACTS[activation_name], _DTYPES[cd],
                stream, ctypes.addressof(launched))
    launches += launched.value
    _build.check(code, 'bytenet_block')
    return y, p, q, stats


def bytenet_block_backward(x, p, q, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2, dy, *,
                           dilation: int, activation_name: str, stats=None, plan: dict = None):
    """(dx, 12 f32 parameter gradients) of the block at (x, p, q) for the
    output gradient ``dy`` (cast to x's type first, as ``_fused_bwd``
    does): K4 on a CUDA tensor, the plain version on a CPU one. K4 reads
    the weights in x's type (rounded here unless they already are, as the
    forward's copies that ``ByteNetBlockFn`` keeps). ``stats``: the
    forward's LayerNorm statistics of x, p, q rows ([3, B, L, 2] f32, as
    ``_forward`` returns them); without them K4 takes them itself.
    ``plan`` (``bytenet_block_backward_plan``) defaults to the shape's own;
    a caller may pass another design's to compare the two."""
    global bwd_launches
    params = (g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2)
    dy = dy.to(x.dtype)
    if x.device.type == 'cpu':
        return bytenet_block_backward_reference(x, p, q, *params, dy, dilation=dilation,
                                                activation_name=activation_name, stats=stats)
    B, L, D, H, K = _check(x, w1, wc, w2, activation_name, 'bytenet_block_backward')
    plan = plan or bytenet_block_backward_plan(B, L, D, H, K, dilation, x.dtype)
    dev, cd = x.device, x.dtype
    x, p, q, dy = (_ready(t, dev, cd) for t in (x, p, q, dy))
    if p.shape != (B, L, H) or q.shape != (B, L, H) or dy.shape != x.shape:
        raise ValueError('bytenet_block_backward: p, q must be [B, L, H] and dy like x')
    if stats is not None:
        stats = _ready(stats, dev, torch.float32)
        if stats.shape != (3, B, L, 2):
            raise ValueError('bytenet_block_backward: stats must be [3, B, L, 2]')
    params = _prepared(params, dev, cd)
    tma = plan['path'] == 'wgmma'
    if tma:
        x, p, q, dy = (_aligned(t) for t in (x, p, q, dy))
        params = tuple(_aligned(t) if i in _WEIGHTS else t for i, t in enumerate(params))
    grads = [torch.empty(t.shape, dtype=torch.float32, device=dev) for t in params]
    dx = torch.empty_like(x)
    lib = _build.load('bytenet_block_bwd', _BWD_SIGNATURES, _BWD_RESTYPES)
    act, dt = _ACTS[activation_name], _DTYPES[cd]
    nbytes = plan['workspace_bytes'] if tma else lib.hd_bytenet_block_bwd_workspace(
        B, L, D, H, K, dt)
    if nbytes <= 0:
        raise ValueError(f'bytenet_block_backward: unsupported shape B={B} L={L} D={D} '
                         f'H={H} K={K}')
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    ptrs = (x.data_ptr(), p.data_ptr(), q.data_ptr(),
            stats.data_ptr() if stats is not None else None, *(t.data_ptr() for t in params),
            dy.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in grads),
            workspace.data_ptr(), B, L, D, H, K, int(dilation), act)
    with _on(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if tma:
            code = lib.hd_bytenet_block_bwd_tma(*ptrs, plan['c_array'], stream,
                                                ctypes.addressof(launched))
        else:
            code = lib.hd_bytenet_block_bwd(*ptrs, dt, stream, ctypes.addressof(launched))
    bwd_launches += launched.value
    _build.check(code, 'bytenet_block_backward')
    return (dx, *grads)


def k2_occupancy(plan: dict) -> list:
    """How a Hopper K2 plan's three launches fit the card in this process:
    the clusters of each that can be resident at once (the CUDA occupancy
    calculator)."""
    lib = _build.load('bytenet_block', _SIGNATURES)
    out = (ctypes.c_int * 3)()
    _build.check(lib.hd_bytenet_block_fwd_occupancy(plan['c_array'], out),
                 'bytenet_block occupancy')
    return list(out)


def k4_occupancy(plan: dict) -> dict:
    """How a Hopper K4 plan's launches fit the card in this process: the
    clusters of each data GEMM that can be resident at once and the
    weight-gradient blocks an SM (the CUDA occupancy calculator)."""
    lib = _build.load('bytenet_block_bwd', _BWD_SIGNATURES, _BWD_RESTYPES)
    out = (ctypes.c_int * 4)()
    _build.check(lib.hd_bytenet_block_bwd_occupancy(plan['c_array'], out),
                 'bytenet_block_backward occupancy')
    return {'data_clusters': list(out[:3]), 'wgrad_blocks_per_sm': out[3]}


def wgmma_trans_a_probe(a, b):
    """The transposed-A wgmma alone on the card: a^T b in f32 for bf16 a
    [64, 64] and b [64, 128] (``trans_a_probe_kernel``), which the weight
    gradients' products are built on; for the card tests, against
    ``torch.matmul``."""
    if a.device.type != 'cuda' or a.shape != (64, 64) or b.shape != (64, 128):
        raise ValueError('wgmma_trans_a_probe: bf16 a [64, 64] and b [64, 128] on a card')
    a, b = (t.to(torch.bfloat16).contiguous() for t in (a, b))
    d = torch.empty(64, 128, dtype=torch.float32, device=a.device)
    lib = _build.load('bytenet_block_bwd', _BWD_SIGNATURES, _BWD_RESTYPES)
    with _on(a.device):
        code = lib.hd_wgmma_trans_a_probe(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                          torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(code, 'wgmma_trans_a_probe')
    return d


class ByteNetBlockFn(torch.autograd.Function):
    """K2 forward keeping p, q, its LayerNorm statistics and the weights it
    read in x's type, K4 backward given them (the custom VJP of
    pallas_bytenet.py:380-407)."""

    @staticmethod
    def forward(ctx, x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2, dilation,
                activation_name):
        params = (g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2)
        if x.device.type != 'cpu':
            params = _prepared(params, x.device, x.dtype)
        y, p, q, stats = _forward(x, params, dilation, activation_name, keep=True)
        ctx.save_for_backward(x, p, q, stats, *params)
        ctx.dilation, ctx.activation_name = dilation, activation_name
        return y

    @staticmethod
    def backward(ctx, dy):
        x, p, q, stats, *params = ctx.saved_tensors
        grads = bytenet_block_backward(x, p, q, *params, dy, dilation=ctx.dilation,
                                       activation_name=ctx.activation_name, stats=stats)
        return (*grads, None, None)


def bytenet_block(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2, *,
                  dilation: int, activation_name: str) -> torch.Tensor:
    """ByteNet block y = x + W2 act(LN3 conv(act(LN2 (W1 act(LN1 x))))) on
    x [B, L, D] (one chain: the conv reads zeros outside [0, L))."""
    params = (g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return ByteNetBlockFn.apply(x, *params, dilation, activation_name)
    return _forward(x, params, dilation, activation_name, keep=False)[0]


def block_matmul_flops(B: int, L: int, D: int, H: int, K: int,
                       backward: bool = False) -> float:
    """Executed matrix-unit FLOPs of one block call, as the JAX package
    counts them (pallas_bytenet.py:438-446): forward Dense D->H, K conv
    taps H x H (every tap, padding included), Dense H->D; a forward and
    backward pass is 3x the forward (the backward's data and weight
    gradients are twice its matmuls)."""
    fwd = 2.0 * B * L * (D * H + K * H * H + H * D)
    return fwd * 3.0 if backward else fwd
