"""The launch plans of K1-K7 on an H100, and (on a card) the Hopper kernels
against their plain versions.

``rope_attention_qkv_plan``, ``bytenet_block_plan``,
``rope_attention_bwd_plan`` and ``bytenet_block_backward_plan`` compute
each launch from the shape alone: the path (TMA + wgmma on Hopper, or the
earlier mma.sync / FMA designs), grid, cluster, shared memory and the TMA
tensor maps. The C entries refuse any plan but their own, so these CPU
tests hold the numbers every launch on the paths would take: B in {1, 16,
64, 128, 512}; L in {291, 152, 139}; 8, 4 and 2 heads; the towers 256/128,
768/384, 512/256 and the demos' 64/32 and 192/96 at K = 13; for the
attention backward B in {16, 32, 128, 512} and L in {291, 152, 100, 37,
17}, both layouts; for K4 B in {16, 32, 128, 512}, L in {152, 139},
dilations 1 and 32.

The tests marked ``cuda`` need an NVIDIA GPU and nvcc and skip without a
card; the file imports neither JAX nor ``hudiff_tpu``:

    python -m pytest --noconftest tests/test_torch_hopper_plans.py -q -m cuda

Their limits are chip_smoke.py's: f32 |err| <= 1e-5 (K1, K3, K6) / 2e-5
(K2); bf16 |err| <= 2**-7 |ref| + 5e-3 (K1, K3, K6) / 2.5e-2 (K2); K4's dx
2**-7 |ref| + 1.5e-2 and its gradients 2e-3 max |ref|.
"""
import re

import numpy as np
import pytest
import torch

from hudiff_tpu_torch.ops import _build
from hudiff_tpu_torch.ops import fused_attention as FA
from hudiff_tpu_torch.ops import fused_bytenet as FB

BATCHES = (1, 16, 64, 128, 512)
LENGTHS = (291, 152, 139)
HEADS = (8, 4, 2)
TOWERS = ((256, 7), (768, 7), (512, 7), (64, 13), (192, 13))   # (D, K); H = D / 2
DILATIONS = (1, 32)
DTYPES = (torch.bfloat16, torch.float32)
MAX_BOX = 256


def _map_ok(tm, elem_bytes=2):
    """A bf16 tensor map as TMA takes it with 128-byte swizzle: 16-byte
    multiples for the inner box extent and the strides, the inner box
    exactly one 128-byte row (64 bf16), no box dimension past 256."""
    inner = tm['box'][0] * elem_bytes
    return (inner % 16 == 0 and inner == 128 and all(0 < b <= MAX_BOX for b in tm['box'])
            and all(s % 16 == 0 for s in tm['strides']) and len(tm['dims']) == len(tm['box']))


# -- K1 ------------------------------------------------------------------------

@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('heads', HEADS)
@pytest.mark.parametrize('L', LENGTHS)
@pytest.mark.parametrize('B', BATCHES)
def test_k1_plan(B, L, heads, dtype):
    plan = FA.rope_attention_qkv_plan(B, L, heads, dtype)
    assert plan['smem_bytes'] <= FA.MAX_SMEM
    gx, gy, gz = plan['grid']
    assert (gy, gz) == (heads, B) and gy <= 65535 and gz <= 65535
    if dtype is torch.float32:
        assert plan['path'] == 'fma' and plan['grid'][0] == -(-L // 64)
        return
    if B * heads < 64:   # few (b, h) pairs: the mma.sync design's block per 64 queries
        assert plan['path'] == 'mma_sync' and plan['grid'][0] == -(-L // 64)
        plan = FA.rope_attention_qkv_plan(B, L, heads, dtype, path='wgmma')
    assert plan['path'] == 'wgmma'   # every length the paths give fits K and V in shared memory
    gx = plan['grid'][0]
    tiles = plan['kv_tiles']
    assert tiles == -(-L // 64) <= FA.K1_MAX_KV_TILES and 1 <= gx <= tiles
    assert plan['smem_bytes'] == (2 * tiles + -(-tiles // gx)) * FA.TILE_BYTES + FA.K1_TMA_EXTRA
    tm = plan['tensor_map']
    assert _map_ok(tm) and tm['swizzle'] == 128
    assert tm['dims'] == (heads * 3 * 64, L, B) and tm['box'] == (64, 64, 1)
    assert plan['threads'] == FA.K1_TMA_THREADS == 256
    assert plan['array'] == (*plan['grid'], 256, plan['smem_bytes'], tiles, *tm['dims'],
                             *tm['strides'], *tm['box'])
    assert list(plan['c_array']) == list(plan['array'])


@pytest.mark.parametrize('B,L,heads,expected', [(16, 291, 8, 2), (64, 291, 8, 2),
                                                (16, 152, 8, 2), (64, 152, 8, 1),
                                                (512, 152, 8, 1), (16, 17, 8, 1)])
def test_k1_split(B, L, heads, expected):
    """A head's query tiles go to two blocks where it has four or more, or
    where (b, h) blocks are few; a split can be asked for, up to the tiles."""
    assert FA.rope_attention_qkv_plan(B, L, heads, torch.bfloat16)['grid'][0] == expected
    tiles = -(-L // 64)
    assert FA.rope_attention_qkv_plan(B, L, heads, torch.bfloat16, split=tiles)['grid'][0] == tiles
    with pytest.raises(ValueError):
        FA.rope_attention_qkv_plan(B, L, heads, torch.bfloat16, split=tiles + 1)


@pytest.mark.parametrize('B,heads', [(1, 8), (4, 8), (7, 8), (16, 2), (1, 2)])
def test_k1_few_heads(B, heads):
    """Below 64 (b, h) pairs (the sequential reference's and a lone
    request's B = 1) the mma.sync design is taken; the Hopper one is there
    on request."""
    assert FA.rope_attention_qkv_plan(B, 291, heads, torch.bfloat16)['path'] == 'mma_sync'
    assert FA.rope_attention_qkv_plan(B, 291, heads, torch.bfloat16,
                                      path='wgmma')['path'] == 'wgmma'
    assert FA.rope_attention_qkv_plan(8, 291, 8, torch.bfloat16)['path'] == 'wgmma'


def test_k1_other_paths():
    """bf16 past L = 384 and on request keep the mma.sync design, f32 the
    FMA path; what no kernel takes raises."""
    assert FA.rope_attention_qkv_plan(16, 385, 8, torch.bfloat16)['path'] == 'mma_sync'
    assert FA.rope_attention_qkv_plan(16, 384, 8, torch.bfloat16)['path'] == 'wgmma'
    old = FA.rope_attention_qkv_plan(16, 291, 8, torch.bfloat16, path='mma_sync')
    assert old['grid'] == (5, 8, 16) and old['smem_bytes'] <= FA.MAX_SMEM
    for bad in [dict(dtype=torch.float16), dict(B=0), dict(L=0), dict(heads=0),
                dict(B=65536), dict(dtype=torch.float32, path='wgmma'),
                dict(L=400, path='wgmma'), dict(path='mma_sync', dtype=torch.float32),
                dict(path='fma'), dict(path='tiles')]:
        kw = {'B': 16, 'L': 291, 'heads': 8, 'dtype': torch.bfloat16, **bad}
        with pytest.raises((TypeError, ValueError)):
            FA.rope_attention_qkv_plan(**kw)


# -- K5 and K7: K1's Hopper body in other layouts ---------------------------------

FWD_LAYOUTS = ('qkv', 'sep', 'blhd', 'bhld')


@pytest.mark.parametrize('layout', FWD_LAYOUTS)
@pytest.mark.parametrize('heads', HEADS)
@pytest.mark.parametrize('L', LENGTHS)
@pytest.mark.parametrize('B', BATCHES)
def test_fwd_plan_layouts(B, L, heads, layout):
    """Every layout takes K1's gate, split and shared memory; only the tensor
    map differs: over qkv [B][L][H 192] (K1), over q, k, v [B][L][H 64] (K5
    and K7's [B, L, H, 64]) or over [B H][L][64] (K7's [B, H, L, 64])."""
    bf = torch.bfloat16
    plan = FA.rope_attention_qkv_plan(B, L, heads, bf, layout=layout)
    k1 = FA.rope_attention_qkv_plan(B, L, heads, bf)
    assert plan['layout'] == layout and plan['rope'] == (layout in ('qkv', 'sep'))
    assert plan['path'] == k1['path'] == ('wgmma' if B * heads >= 64 else 'mma_sync')
    f32 = FA.rope_attention_qkv_plan(B, L, heads, torch.float32, layout=layout)
    assert f32['path'] == 'fma' and f32['grid'] == (-(-L // 64), heads, B)
    plan = FA.rope_attention_qkv_plan(B, L, heads, bf, path='wgmma', layout=layout)
    k1 = FA.rope_attention_qkv_plan(B, L, heads, bf, path='wgmma')
    for key in ('grid', 'threads', 'cluster', 'kv_tiles', 'smem_bytes'):
        assert plan[key] == k1[key], key
    tiles = plan['kv_tiles']
    assert plan['smem_bytes'] == (2 * tiles + -(-tiles // plan['grid'][0])) * FA.TILE_BYTES \
        + FA.K1_TMA_EXTRA <= FA.MAX_SMEM
    A = heads * 64
    dims = {'qkv': (3 * A, L, B), 'sep': (A, L, B), 'blhd': (A, L, B),
            'bhld': (64, L, B * heads)}[layout]
    tm = plan['tensor_map']
    assert _map_ok(tm) and tm['dims'] == dims and tm['box'] == (64, 64, 1)
    assert tm['strides'] == (dims[0] * 2, L * dims[0] * 2) and tm['swizzle'] == 128
    assert plan['array'] == (*plan['grid'], 256, plan['smem_bytes'], tiles, *dims,
                             *tm['strides'], 64, 64, 1)
    assert len(plan['array']) == 14 and list(plan['c_array']) == list(plan['array'])


def test_k1_plan_is_the_qkv_layouts():
    """K1's plan is the 'qkv' layout's (with the rotation), 14 values: the
    grid, 256 threads (two warpgroups, no producer warp), shared memory, K/V
    tiles and the map over qkv (here at B = 16, L = 291 and B = 64, L =
    152, 8 heads)."""
    bf = torch.bfloat16
    assert FA.rope_attention_qkv_plan(16, 291, 8, bf)['array'] == (
        2, 8, 16, 256, 107648, 5, 1536, 291, 16, 3072, 893952, 64, 64, 1)
    assert FA.rope_attention_qkv_plan(64, 152, 8, bf)['array'] == (
        1, 8, 64, 256, 74880, 3, 1536, 152, 64, 3072, 466944, 64, 64, 1)
    for B, L, heads in ((16, 291, 8), (64, 152, 8), (1, 291, 8), (128, 291, 4)):
        a = FA.rope_attention_qkv_plan(B, L, heads, bf)
        b = FA.rope_attention_qkv_plan(B, L, heads, bf, layout='qkv')
        assert {k: v for k, v in a.items() if k != 'c_array'} == \
            {k: v for k, v in b.items() if k != 'c_array'}
        assert a['layout'] == 'qkv' and a['rope'] is True


@pytest.mark.parametrize('layout', FWD_LAYOUTS)
def test_fwd_plan_refusals(layout):
    """What no kernel takes raises in every layout: the Hopper design in
    f32 or past L = 384, mma.sync in f32, an unknown layout; below 64 (b, h)
    pairs the mma.sync design is taken and the Hopper one is there on
    request; the plan rotates q and k in the layouts that do."""
    bf = torch.bfloat16
    rotates = layout in ('qkv', 'sep')
    for bad in [dict(dtype=torch.float32, path='wgmma'), dict(L=400, path='wgmma'),
                dict(dtype=torch.float32, path='mma_sync'), dict(path='fma'),
                dict(dtype=torch.float16), dict(B=0), dict(split=6)]:
        kw = {'B': 16, 'L': 291, 'heads': 8, 'dtype': bf, 'layout': layout, **bad}
        with pytest.raises((TypeError, ValueError)):
            FA.rope_attention_qkv_plan(**kw)
    assert FA.rope_attention_qkv_plan(16, 400, 8, bf, layout=layout)['path'] == 'mma_sync'
    assert FA.rope_attention_qkv_plan(7, 291, 8, bf, layout=layout)['path'] == 'mma_sync'
    assert FA.rope_attention_qkv_plan(7, 291, 8, bf, layout=layout,
                                      path='wgmma')['path'] == 'wgmma'
    assert FA.rope_attention_qkv_plan(16, 291, 8, bf, layout=layout)['rope'] == rotates
    for other in ('bshd', 'BLHD', None):
        with pytest.raises(ValueError):
            FA.rope_attention_qkv_plan(16, 291, 8, bf, layout=other)


# -- K2 ------------------------------------------------------------------------

def _k2_launches_ok(plan, B, L, D, H, K, tiles=None):
    """Every launch of a Hopper K2 plan as the C entry takes it: the grid of
    column and row tiles, a cluster over a row tile's column tiles for F1
    and F2 (at most 8), the ring's stages and shared memory (two blocks an
    SM where planned), the A rows' and weights' 2-D tensor maps, the
    programmatic launch of F2 and F3, and the C array; the column tiles
    the plan's own (``tiles`` where asked for)."""
    gemms = ((D, H, 1, True), (H, H, K, True), (H, D, 1, False))
    wide = plan['path'] == 'wgmma128'
    bm = 128 if wide else 64
    for i, (ln, (C, N, taps, next_ln)) in enumerate(zip(plan['launches'], gemms)):
        bn = ln['bn']
        assert ln['bm'] == bm and N % bn == 0
        if wide:   # 256 columns for F1 where N is a multiple of 256
            assert bn == (tiles or (256 if i == 0 and N % 256 == 0 else 128))
        else:      # 64 columns where a launch has at most K2_NARROW_TILES 64 x 128 tiles
            narrow = N // 128 * -(-B * L // 64) <= FB.K2_NARROW_TILES[i]
            assert bn == (tiles or (64 if narrow and (not next_ln or N // 64 <= 8) else 128))
        assert ln['grid'] == (N // bn, -(-B * L // bm), 1) and max(ln['grid'][1:]) <= 65535
        assert ln['cluster'] == ((N // bn if next_ln else 1), 1, 1)
        assert ln['cluster'][0] <= FB.MAX_CLUSTER
        blocks = ln['grid'][0] * ln['grid'][1]
        if wide:   # 128 columns: six stages where the blocks fit the SMs one each, else
            # three, two an SM; 256 columns (where N allows them): four, one an SM
            assert ln['stages'] == (4 if bn == 256 else 6 if blocks <= 132 else 3)
            assert ln['smem_bytes'] == FB.k2_wide_smem(ln['stages'], bn)
        else:      # eight for F1 and where the blocks fit the SMs, else four
            assert ln['stages'] == (8 if i == 0 or blocks <= 132 else 4)
            assert ln['smem_bytes'] == FB.k2_tma_smem(ln['stages'], bn)
        assert ln['threads'] == (544 if bn == 256 else 288)   # 4 or 2 consumer warpgroups
        assert ln['smem_bytes'] <= FB.MAX_SMEM
        one_an_sm = ln['stages'] in (6, 8) or bn == 256
        assert one_an_sm or 2 * (ln['smem_bytes'] + 1024) <= 233472
        assert ln['chunks'] == taps * C // 64
        assert ln['pdl'] == (i > 0)   # F2 and F3 start under the previous launch's tail
        assert _map_ok(ln['a_map']) and _map_ok(ln['w_map'])
        assert ln['a_map']['dims'] == (C, B * L) and ln['a_map']['box'] == (64, bm)
        assert ln['w_map']['dims'] == (taps * C, N) and ln['w_map']['box'] == (64, bn)
        assert ln['array'] == (*ln['grid'], ln['cluster'][0], ln['threads'], ln['smem_bytes'],
                               bm, bn, ln['stages'], int(ln['pdl']), C, B * L, 2 * C, 64, bm,
                               taps * C, N, 2 * taps * C, 64, bn)
        assert len(ln['array']) == FB.K2_PLAN_LEN
    assert plan['array'] == sum((ln['array'] for ln in plan['launches']), ())
    assert list(plan['c_array']) == list(plan['array'])


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('D,K', TOWERS)
@pytest.mark.parametrize('L', LENGTHS)
@pytest.mark.parametrize('B', BATCHES)
def test_k2_plan(B, L, D, K, dtype):
    H = D // 2
    for dil in DILATIONS:
        plan = FB.bytenet_block_plan(B, L, D, H, K, dil, dtype)
        assert len(plan['launches']) == 3
        for ln in plan['launches']:
            assert ln['smem_bytes'] <= FB.MAX_SMEM
            assert all(0 < g <= 2 ** 31 - 1 for g in ln['grid']) and max(ln['grid'][1:]) <= 65535
        if dtype is torch.float32:
            assert plan['path'] == 'fma'
            continue
        wide = D % 128 == 0 and H % 128 == 0
        assert plan['path'] == (FB._k2_design(B * L, D, H) if wide else 'mma_sync')
        if not wide:
            for path in FB.K2_HOPPER:
                with pytest.raises(ValueError):
                    FB.bytenet_block_plan(B, L, D, H, K, dil, dtype, path=path)
            continue
        for path in FB.K2_HOPPER:   # every Hopper design takes the shape, on request too
            _k2_launches_ok(FB.bytenet_block_plan(B, L, D, H, K, dil, dtype, path=path),
                            B, L, D, H, K)
        if plan['path'] in FB.K2_HOPPER:
            _k2_launches_ok(plan, B, L, D, H, K)
        # the same plan at every dilation: the choice depends on the shape alone
        assert plan['launches'] == FB.bytenet_block_plan(B, L, D, H, K, 1, dtype)['launches']


def test_k2_plan_choices():
    """The 64-row design's column tiles (64 where a launch has at most its
    K2_NARROW_TILES 64 x 128 tiles, on request 64 or 128 for every launch or
    for each, 128 where 64 would make a cluster past 8), the 128-row
    design's (256 for F1 where N is a multiple of 256) and the programmatic
    launch of F2 and F3 (off on request)."""
    bf = torch.bfloat16
    plan = FB.bytenet_block_plan(16, 152, 256, 128, 7, 1, bf, path='wgmma')
    assert [ln['bn'] for ln in plan['launches']] == [64, 64, 64]   # 38, 38 and 76 tiles
    plan = FB.bytenet_block_plan(16, 152, 768, 384, 7, 1, bf, path='wgmma')
    assert [ln['bn'] for ln in plan['launches']] == [128, 128, 64]   # 114, 114 and 228 tiles
    plan = FB.bytenet_block_plan(16, 152, 512, 256, 7, 1, bf, path='wgmma')
    assert [ln['bn'] for ln in plan['launches']] == [128, 64, 64]    # 76, 76 and 152 tiles
    plan = FB.bytenet_block_plan(1, 139, 768, 384, 7, 1, bf, path='wgmma')
    assert [ln['bn'] for ln in plan['launches']] == [64, 64, 64]
    plan = FB.bytenet_block_plan(16, 152, 768, 384, 7, 1, bf, path='wgmma', bn=(64, None, 64))
    assert [ln['bn'] for ln in plan['launches']] == [64, 128, 64]
    for bn in (64, 128):
        plan = FB.bytenet_block_plan(16, 152, 768, 384, 7, 1, bf, path='wgmma', bn=bn)
        assert [ln['bn'] for ln in plan['launches']] == [bn] * 3
        _k2_launches_ok(plan, 16, 152, 768, 384, 7, bn)
    plan = FB.bytenet_block_plan(16, 152, 1024, 1024, 7, 1, bf, path='wgmma')
    assert [ln['cluster'][0] for ln in plan['launches']] == [8, 8, 1]
    with pytest.raises(ValueError):   # 16 column tiles of 64: a cluster past 8
        FB.bytenet_block_plan(16, 152, 1024, 1024, 7, 1, bf, path='wgmma', bn=64)
    # the 128-row design: 256 columns for F1 where N is a multiple of 256, on request
    # for any launch whose N is
    plan = FB.bytenet_block_plan(512, 152, 512, 256, 7, 1, bf, path='wgmma128')
    assert [ln['bn'] for ln in plan['launches']] == [256, 128, 128]
    assert [ln['cluster'][0] for ln in plan['launches']] == [1, 2, 1]
    plan = FB.bytenet_block_plan(512, 152, 512, 256, 7, 1, bf, path='wgmma128', bn=256)
    assert [ln['bn'] for ln in plan['launches']] == [256, 256, 256]
    _k2_launches_ok(plan, 512, 152, 512, 256, 7, 256)
    plan = FB.bytenet_block_plan(128, 152, 768, 384, 7, 1, bf, path='wgmma128')
    assert [ln['bn'] for ln in plan['launches']] == [128, 128, 128]
    plan = FB.bytenet_block_plan(512, 152, 512, 256, 7, 1, bf, path='wgmma128', bn=128)
    assert [ln['bn'] for ln in plan['launches']] == [128] * 3
    _k2_launches_ok(plan, 512, 152, 512, 256, 7, 128)
    with pytest.raises(ValueError):   # 384 columns are no 256-column tiles
        FB.bytenet_block_plan(128, 152, 768, 384, 7, 1, bf, path='wgmma128', bn=256)
    plan = FB.bytenet_block_plan(16, 152, 768, 384, 7, 1, bf, pdl=False)
    assert [ln['pdl'] for ln in plan['launches']] == [False] * 3
    assert [ln['array'][9] for ln in plan['launches']] == [0, 0, 0]
    assert [ln['array'][9] for ln in FB.bytenet_block_plan(16, 152, 768, 384, 7, 1, bf)[
        'launches']] == [0, 1, 1]
    for bad in ((64, 64), (64, 32, 64)):
        with pytest.raises(ValueError):
            FB.bytenet_block_plan(16, 152, 768, 384, 7, 1, bf, path='wgmma', bn=bad)


def test_k2_paths_on_the_main_shapes():
    """The design each path shape takes, where it read fastest on an H100
    (bytenet_fwd_sweep --shapes paths): the 64-row design at B = 1 and 16
    (the sampler's, the service's) and on the 256/128 tower at B = 32, the
    128-row one past them (the fine-tune, the bench's sampler, pretraining:
    768/384 at B = 128, 512/256 at B = 512); mma.sync for the demos' widths
    and on request, FMA for f32."""
    path = lambda *a, **k: FB.bytenet_block_plan(*a, **k)['path']  # noqa: E731
    bf = torch.bfloat16
    for B, L in ((1, 152), (16, 152), (1, 139), (16, 139)):
        for D in (768, 512, 256):
            assert path(B, L, D, D // 2, 7, 4, bf) == 'wgmma'
    for B, L in ((32, 152), (32, 139), (64, 152), (64, 139), (128, 152), (128, 139),
                 (512, 152)):
        for D in (768, 512):
            assert path(B, L, D, D // 2, 7, 32, bf) == 'wgmma128'
        assert path(B, L, 256, 128, 7, 1, bf) == ('wgmma' if B == 32 else 'wgmma128')
    for D in (64, 192, 128):
        assert path(512, 152, D, D // 2, 13, 1, bf) == 'mma_sync'
    assert path(64, 152, 768, 384, 7, 1, torch.float32) == 'fma'
    for B in (16, 128, 512):
        for p in ('wgmma', 'wgmma128', 'mma_sync'):
            assert path(B, 152, 768, 384, 7, 1, bf, path=p) == p
    # the mma.sync design's tiles: 64 x 64 (clusters of 6) at B = 64, 128 x 128 (of 3) at 128
    for B, c in ((64, 6), (128, 3)):
        pr5 = FB.bytenet_block_plan(B, 152, 768, 384, 7, 1, bf, path='mma_sync')
        assert [ln['cluster'] for ln in pr5['launches']] == [(1, c, 1), (1, c, 1), (1, 1, 1)]


def test_k2_refusals():
    """What no kernel takes raises: an even K, widths past 1024 or not
    multiples of 32, an empty shape, another dtype; a Hopper design at
    widths that are not multiples of 128 or in f32, mma.sync in f32, FMA in
    bf16, an unknown design; column tiles other than 64 and 128 (128 alone
    in the 128-row design); tiles or a launch mode for a design that picks
    its own."""
    bf = torch.bfloat16
    for args in [(16, 152, 768, 384, 6, 1, bf), (16, 152, 770, 385, 7, 1, bf),
                 (16, 152, 2048, 1024, 7, 1, bf), (0, 152, 768, 384, 7, 1, bf),
                 (16, 152, 768, 384, 7, 0, bf)]:
        with pytest.raises(ValueError):
            FB.bytenet_block_plan(*args)
    with pytest.raises(TypeError):
        FB.bytenet_block_plan(16, 152, 768, 384, 7, 1, torch.float16)
    for args, kw in [((16, 152, 128, 64, 13, 1, bf), dict(path='wgmma')),
                     ((16, 152, 128, 64, 13, 1, bf), dict(path='wgmma128')),
                     ((64, 152, 192, 96, 13, 1, bf), dict(path='wgmma')),
                     ((64, 152, 768, 384, 7, 1, torch.float32), dict(path='wgmma128')),
                     ((64, 152, 768, 384, 7, 1, torch.float32), dict(path='mma_sync')),
                     ((64, 152, 768, 384, 7, 1, bf), dict(path='fma')),
                     ((64, 152, 768, 384, 7, 1, bf), dict(path='tiles')),
                     ((64, 152, 768, 384, 7, 1, bf), dict(path='wgmma', bn=32)),
                     ((64, 152, 768, 384, 7, 1, bf), dict(path='wgmma128', bn=64)),
                     ((64, 152, 768, 384, 7, 1, bf), dict(path='mma_sync', bn=64)),
                     ((64, 152, 768, 384, 7, 1, bf), dict(path='mma_sync', pdl=False)),
                     ((64, 152, 768, 384, 7, 1, torch.float32), dict(bn=128))]:
        with pytest.raises(ValueError):
            FB.bytenet_block_plan(*args, **kw)


def test_k2_cpu_tensors_take_the_plain_version():
    """On the CPU the forward runs its plain version, whatever the plan, and
    launches nothing."""
    g = torch.Generator().manual_seed(19)
    B, L, D, H, K = 2, 19, 256, 128, 3
    x = torch.randn(B, L, D, generator=g).bfloat16()
    params = [torch.randn(s, generator=g) * 0.1 + (1.0 if i in (0, 4, 8) else 0.0)
              for i, s in enumerate(((D,), (D,), (H, D), (H,), (H,), (H,), (H, K, H), (H,),
                                     (H,), (H,), (D, H), (D,)))]
    want = FB.bytenet_block_reference(x, *params, dilation=2, activation_name='gelu')
    before = FB.launches
    for path in FB.K2_PATHS[:3]:
        plan = FB.bytenet_block_plan(B, L, D, H, K, 2, torch.bfloat16, path=path)
        assert torch.equal(FB._forward(x, params, 2, 'gelu', keep=False, plan=plan)[0], want)
    assert FB.launches == before


# -- K3 and K6 -----------------------------------------------------------------

BWD_BATCHES = (16, 32, 128, 512)
BWD_LENGTHS = (291, 152, 100, 37, 17)


@pytest.mark.parametrize('layout', FA.K3_LAYOUTS)
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('heads', HEADS)
@pytest.mark.parametrize('L', BWD_LENGTHS)
@pytest.mark.parametrize('B', BWD_BATCHES)
def test_k3_plan(B, L, heads, dtype, layout):
    plan = FA.rope_attention_bwd_plan(B, L, heads, dtype, layout=layout)
    tiles = -(-L // 64)
    assert plan['smem_bytes'] <= FA.MAX_SMEM
    if dtype is torch.float32:
        assert plan['path'] == 'fma' and plan['grid'] == (tiles, heads, B)
        return
    assert plan['path'] == 'wgmma'   # every length the paths give holds a head's walked pair
    old = FA.rope_attention_bwd_plan(B, L, heads, dtype, path='mma_sync', layout=layout)
    assert old['grid'] == (tiles, heads, B) and old['threads'] == 128
    split = plan['grid'][0]
    assert plan['grid'] == (split, heads, B) and 1 <= split <= tiles <= FA.K3_MAX_TILES
    # the fewest blocks a head that fit, raised while the grid is small
    first = next(x for x in range(1, tiles + 1) if FA._bwd_tma_smem(tiles, x, L) <= FA.MAX_SMEM)
    assert split == max(first, min(tiles, -(-FA.K3_MIN_BLOCKS // (B * heads))))
    assert plan['groups'] == (2 if split < tiles and tiles > 2 else 1)
    assert plan['tiles'] == tiles and plan['groups'] in FA.K3_GROUPS
    assert plan['threads'] == 128 * plan['groups']
    resident = -(-tiles // split)   # tiles, lse and delta, the cos and sin tables
    assert plan['smem_bytes'] == ((2 * tiles + 2 * resident) * FA.TILE_BYTES + 2 * tiles * 64 * 4
                                  + 2 * L * 32 * 4 + FA.K1_TMA_EXTRA) <= FA.MAX_SMEM
    maps = plan['tensor_maps']
    A = heads * 64
    for m in 'qkv':   # K3's three maps are one, over the merged qkv
        assert maps[m]['dims'] == ((3 * A if layout == 'qkv' else A), L, B)
    assert maps['do']['dims'] == (A, L, B)
    for tm in maps.values():
        assert _map_ok(tm) and tm['swizzle'] == 128 and tm['box'] == (64, 64, 1)
        assert tm['strides'] == (tm['dims'][0] * 2, tm['dims'][1] * tm['dims'][0] * 2)
    assert plan['array'] == (*plan['grid'], plan['threads'], plan['smem_bytes'], tiles,
                             *(v for m in ('q', 'k', 'v', 'do')
                               for k in ('dims', 'strides', 'box') for v in maps[m][k]))
    assert len(plan['array']) == 38 and list(plan['c_array']) == list(plan['array'])


def test_k3_paths_and_splits():
    """The Hopper design at the Ab and Nb training steps' shapes (B = 128,
    L = 291 and B = 512, L = 152, 8 heads) and a tensor-parallel rank's 4
    and 2 heads, with the splits and warpgroups that read fastest there;
    every split whose shared memory fits can be asked for."""
    bf = torch.bfloat16
    for B, L, heads, grid, groups in ((128, 291, 8, 2, 2), (512, 152, 8, 1, 2),
                                      (128, 291, 4, 2, 2), (128, 291, 2, 2, 2),
                                      (16, 291, 2, 4, 2), (128, 100, 8, 1, 1),
                                      (128, 37, 8, 1, 1)):
        for layout in FA.K3_LAYOUTS:
            plan = FA.rope_attention_bwd_plan(B, L, heads, bf, layout=layout)
            assert plan['path'] == 'wgmma' and plan['grid'] == (grid, heads, B)
            assert plan['groups'] == groups
    for L in (384, 291, 152, 17):
        tiles = -(-L // 64)
        for split in range(1, tiles + 1):
            fits = FA._bwd_tma_smem(tiles, split, L) <= FA.MAX_SMEM
            for groups in FA.K3_GROUPS:
                if not fits:   # the tiles and tables would not fit a block's shared memory
                    with pytest.raises(ValueError):
                        FA.rope_attention_bwd_plan(16, L, 8, bf, split=split, groups=groups)
                    continue
                plan = FA.rope_attention_bwd_plan(16, L, 8, bf, split=split, groups=groups)
                assert plan['grid'] == (split, 8, 16) and plan['threads'] == 128 * groups
        with pytest.raises(ValueError):
            FA.rope_attention_bwd_plan(16, L, 8, bf, split=tiles + 1)
    assert FA._bwd_tma_smem(5, 1, 291) > FA.MAX_SMEM   # L = 291 takes two blocks a head or more
    old = FA.rope_attention_bwd_plan(128, 291, 8, bf, path='mma_sync')
    assert old['grid'] == (5, 8, 128) and old['smem_bytes'] <= FA.MAX_SMEM


def test_k3_refusals():
    """What no kernel takes raises: another dtype, an empty or oversized
    shape, a layout or path that does not exist, the Hopper design in f32
    or past L = 384, mma.sync in f32, FMA in bf16, a split of no tile, a
    number of warpgroups no kernel has."""
    assert FA.rope_attention_bwd_plan(128, 385, 8, torch.bfloat16)['path'] == 'mma_sync'
    assert FA.rope_attention_bwd_plan(128, 384, 8, torch.bfloat16)['path'] == 'wgmma'
    for bad in [dict(dtype=torch.float16), dict(B=0), dict(L=0), dict(heads=0),
                dict(B=65536), dict(layout='bhld'), dict(dtype=torch.float32, path='wgmma'),
                dict(L=400, path='wgmma'), dict(path='mma_sync', dtype=torch.float32),
                dict(path='fma'), dict(path='tiles'), dict(split=0), dict(split=6),
                dict(groups=0), dict(groups=3)]:
        kw = {'B': 128, 'L': 291, 'heads': 8, 'dtype': torch.bfloat16, **bad}
        with pytest.raises((TypeError, ValueError)):
            FA.rope_attention_bwd_plan(**kw)


# -- K4 ------------------------------------------------------------------------

K4_BATCHES = (16, 32, 128, 512)
K4_LENGTHS = (152, 139)


@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('dil', DILATIONS)
@pytest.mark.parametrize('D,K', TOWERS)
@pytest.mark.parametrize('L', K4_LENGTHS)
@pytest.mark.parametrize('B', K4_BATCHES)
def test_k4_plan(B, L, D, K, dil, dtype):
    """K4's plan at every shape the paths give it: the Hopper design for
    bf16 with D and H multiples of 128 (its three data GEMMs on 128 x 128
    tiles in clusters over a row tile's columns, the weight gradients on
    128 x 128 tiles of the rows' splits, the sum, twelve 64 x 64 tensor
    maps), mma.sync for the demos' widths, FMA for f32."""
    H, M = D // 2, B * L
    plan = FB.bytenet_block_backward_plan(B, L, D, H, K, dil, dtype)
    if dtype is torch.float32:
        assert plan == {'path': 'fma'}
        return
    if D % 128 or H % 128:
        assert plan == {'path': 'mma_sync'}
        with pytest.raises(ValueError):
            FB.bytenet_block_backward_plan(B, L, D, H, K, dil, dtype, path='wgmma')
        return
    if H == 128 and M <= 8192:   # one column tile, few row tiles: mma.sync read faster
        assert plan == {'path': 'mma_sync'}
        plan = FB.bytenet_block_backward_plan(B, L, D, H, K, dil, dtype, path='wgmma')
    assert plan['path'] == 'wgmma'
    rows = -(-M // 128)
    for ln, (N, C, taps) in zip(plan['data'], ((H, D, 1), (H, H, K), (D, H, 1))):
        assert ln['grid'] == (N // 128, rows, 1) and max(ln['grid']) <= 65535
        assert ln['cluster'] == (N // 128, 1, 1) and ln['cluster'][0] <= FB.MAX_CLUSTER
        assert ln['threads'] == 288 and ln['chunks'] == taps * C // 64
        assert ln['stages'] == FB.K4_DATA_STAGES == 3   # two blocks an SM
        assert 2 * (ln['smem_bytes'] + 1024) <= 233472
        assert ln['smem_bytes'] == FB.k4_data_smem(3) <= FB.MAX_SMEM
    w = plan['wgrad']
    tiles = (D // 128) * (H // 128) + (H // 128) * (K * H // 128) + (H // 128) * (D // 128)
    chunk, splits = w['chunk'], w['splits']
    assert chunk % 64 == 0 and splits == -(-M // chunk) and (splits - 1) * chunk < M
    assert splits == -(-M // FB._split_rows(M, min(max(-(-4 * 132 // tiles), 1),
                                                    -(-M // 2048))))
    assert w['blocks'] == tiles * splits and w['threads'] == 288
    assert w['stages'] == (6 if w['blocks'] <= 132 else 3)
    assert w['smem_bytes'] == FB.k4_wgrad_smem(w['stages']) <= FB.MAX_SMEM
    assert w['stages'] == 6 or 2 * (w['smem_bytes'] + 1024) <= 233472
    assert plan['sum'] == {'blocks': min(-(-max(H * K * H, D * H) // 256), 264), 'jobs': 12,
                           'threads': 256}
    maps = plan['tensor_maps']
    assert list(maps) == ['dy', 'w2', 'q', 'dq', 'wc', 'p', 'dp', 'w1', 'x', 'e', 'bb', 'a']
    for name, (cols, rws) in {'dy': (D, M), 'w2': (H, D), 'q': (H, M), 'dq': (H, M),
                              'wc': (K * H, H), 'p': (H, M), 'dp': (H, M), 'w1': (D, H),
                              'x': (D, M), 'e': (H, M), 'bb': (H, M), 'a': (D, M)}.items():
        tm = maps[name]
        assert tm['dims'] == (cols, rws) and tm['strides'] == (cols * 2,) and tm['box'] == (64, 64)
        assert _map_ok(tm) and tm['swizzle'] == 128
    part = lambda n: -(-n // 256) * 256  # noqa: E731
    assert plan['workspace_bytes'] == (4 * part(M * H * 2) + part(M * D * 2)
                                       + 2 * part(3 * rows * H * 4) + part(3 * rows * D * 4)
                                       + part(splits * D * H * 4) + part(splits * H * K * H * 4)
                                       + part(splits * H * D * 4))
    a = plan['array']
    assert len(a) == FB.K4_PLAN_LEN and list(plan['c_array']) == list(a)
    assert a[:3] == (plan['workspace_bytes'], splits, chunk)
    assert a[21:28] == (w['blocks'], 288, w['smem_bytes'], w['stages'], plan['sum']['blocks'],
                        12, 256)
    # the same plan at every dilation: the choice depends on the shape alone
    assert plan['array'] == FB.bytenet_block_backward_plan(B, L, D, H, K, 1, dtype,
                                                           path='wgmma')['array']


def test_k4_paths_and_splits():
    """The Hopper design on the training paths' towers (768/384 and 512/256
    at B = 16-512, 256/128 past 8192 rows); mma.sync for 256/128 up to 8192
    rows, on request for the other shapes, and for the demos' widths; every split of the rows in 64-row chunks can be asked
    for, and a split count that rounds to fewer chunks gives their number."""
    bf = torch.bfloat16
    path = lambda *a, **k: FB.bytenet_block_backward_plan(*a, **k)['path']  # noqa: E731
    for B in (16, 32, 128, 512):
        for D in (768, 512, 256):
            # the 256/128 tower at B <= 32 (the fine-tune step) keeps mma.sync
            want = 'mma_sync' if D == 256 and B <= 32 else 'wgmma'
            assert path(B, 152, D, D // 2, 7, 1, bf) == path(B, 139, D, D // 2, 7, 1, bf) == want
            assert path(B, 139, D, D // 2, 7, 32, bf, path='mma_sync') == 'mma_sync'
            assert path(B, 139, D, D // 2, 7, 32, bf, path='wgmma') == 'wgmma'
    assert path(53, 152, 256, 128, 7, 1, bf) == 'mma_sync' and path(54, 152, 256, 128, 7, 1,
                                                                     bf) == 'wgmma'
    for D in (64, 192):
        assert path(128, 152, D, D // 2, 13, 1, bf) == 'mma_sync'
    # the splits that read fastest on an H100 (bytenet_bwd_sweep --splits):
    # 768/384 and 256/128 at B = 128, 512/256 and 256/128 at B = 512
    for D, B, splits in ((768, 128, 6), (256, 128, 10), (512, 512, 12), (256, 512, 38)):
        assert FB.bytenet_block_backward_plan(B, 152, D, D // 2, 7, 1,
                                              bf)['wgrad']['splits'] == splits
    M = 128 * 152
    for splits in (1, 2, 3, 5, 16, 304):
        plan = FB.bytenet_block_backward_plan(128, 152, 768, 384, 7, 1, bf, splits=splits)
        w = plan['wgrad']
        assert w['chunk'] == FB._split_rows(M, splits) and w['splits'] == -(-M // w['chunk'])
        assert w['splits'] <= splits and w['blocks'] == 99 * w['splits']


def test_k4_refusals():
    """What no kernel takes raises: another dtype, an empty or oversized
    shape, an even K, widths past 1024 or not multiples of 32; the Hopper
    design in f32 or at widths that are not multiples of 128; mma.sync in
    f32; FMA in bf16; a split of no row or past the 64-row chunks; a split
    for a design that picks its own."""
    bf = torch.bfloat16
    with pytest.raises(TypeError):
        FB.bytenet_block_backward_plan(16, 152, 768, 384, 7, 1, torch.float16)
    for args in [(16, 152, 768, 384, 6, 1, bf), (16, 152, 770, 385, 7, 1, bf),
                 (16, 152, 2048, 1024, 7, 1, bf), (0, 152, 768, 384, 7, 1, bf),
                 (16, 0, 768, 384, 7, 1, bf), (16, 152, 768, 384, 7, 0, bf),
                 (1 << 20, 2048, 768, 384, 7, 1, bf)]:
        with pytest.raises(ValueError):
            FB.bytenet_block_backward_plan(*args)
    for args, kw in [((16, 152, 192, 96, 13, 1, bf), dict(path='wgmma')),
                     ((16, 152, 768, 384, 7, 1, torch.float32), dict(path='wgmma')),
                     ((16, 152, 768, 384, 7, 1, torch.float32), dict(path='mma_sync')),
                     ((16, 152, 768, 384, 7, 1, bf), dict(path='fma')),
                     ((16, 152, 768, 384, 7, 1, bf), dict(path='tiles')),
                     ((16, 152, 768, 384, 7, 1, bf), dict(splits=0)),
                     ((16, 152, 768, 384, 7, 1, bf), dict(splits=39)),
                     ((16, 152, 768, 384, 7, 1, bf), dict(path='mma_sync', splits=2))]:
        with pytest.raises(ValueError):
            FB.bytenet_block_backward_plan(*args, **kw)


def test_k4_cpu_tensors_take_the_plain_version():
    """On the CPU the backward runs its plain version, whatever the plan."""
    g = torch.Generator().manual_seed(17)
    B, L, D, H, K = 2, 19, 128, 128, 3
    x, dy = (torch.randn(B, L, D, generator=g).bfloat16() for _ in range(2))
    p, q = (torch.randn(B, L, H, generator=g).bfloat16() for _ in range(2))
    params = [torch.randn(s, generator=g) * 0.1 + (1.0 if i in (0, 4, 8) else 0.0)
              for i, s in enumerate(((D,), (D,), (H, D), (H,), (H,), (H,), (H, K, H), (H,),
                                     (H,), (H,), (D, H), (D,)))]
    kw = dict(dilation=2, activation_name='gelu')
    want = FB.bytenet_block_backward_reference(x, p, q, *params, dy, **kw)
    before = FB.bwd_launches
    for path in ('wgmma', 'mma_sync'):
        plan = FB.bytenet_block_backward_plan(B, L, D, H, K, 2, torch.bfloat16, path=path)
        got = FB.bytenet_block_backward(x, p, q, *params, dy, **kw, plan=plan)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert FB.bwd_launches == before


def test_plans_mirror_the_sources():
    """The constants the plans use are the CUDA sources' own."""
    src = {n: (_build.CSRC_DIR / n).read_text()
           for n in ('attention_tiles.cuh', 'rope_attention.cu', 'bytenet_block.cu',
                     'rope_attention_bwd.cu', 'wgmma_tiles.cuh')}
    num = lambda name, text: int(re.search(rf'constexpr int {name} = (\d+);', text).group(1))  # noqa: E731
    assert num('MAX_SMEM', src['attention_tiles.cuh']) == FA.MAX_SMEM == FB.MAX_SMEM
    assert num('TMA_MAX_TILES', src['rope_attention.cu']) == FA.K1_MAX_KV_TILES
    assert num('TMA_GROUPS', src['rope_attention.cu']) == 2
    k2 = src['bytenet_block.cu']
    assert num('TMA_BM', k2) == FB.K2_TMA_BM and num('WIDE_BM', k2) == FB.K2_WIDE_BM
    assert num('TMA_BN', k2) == FB.K2_TMA_BN
    assert num('TMA_MAX_SMEM', k2) == FB.MAX_SMEM
    assert num('MAX_CLUSTER', k2) == FB.MAX_CLUSTER
    assert 'constexpr int TMA_STAGES[2] = {%d, %d};' % FB.K2_TMA_STAGES in k2
    assert 'constexpr int WIDE_STAGES[2] = {%d, %d};' % FB.K2_WIDE_STAGES in k2
    assert num('PLAN_LEN', k2) == FB.K2_PLAN_LEN == 20
    for name in ('wgmma_bytenet_fwd_gemm_kernel', 'wgmma_wide_bytenet_fwd_gemm_kernel',
                 'hd_bytenet_block_fwd_tma', 'hd_bytenet_block_fwd_occupancy',
                 'cudaLaunchAttributeProgrammaticStreamSerialization'):
        assert name in k2, name
    bwd = src['rope_attention_bwd.cu']
    assert num('TMA_MAX_TILES', bwd) == FA.K3_MAX_TILES
    assert num('BT', bwd) == 64
    assert num('PLAN_LEN', bwd) == len(FA.rope_attention_bwd_plan(128, 291, 8,
                                                                   torch.bfloat16)['array'])
    assert num('TMA_BARS', bwd) + num('SMEM_SLACK', src['wgmma_tiles.cuh']) == FA.K1_TMA_EXTRA
    fwd = src['rope_attention.cu']
    assert num('TMA_BARS', fwd) + num('SMEM_SLACK', src['wgmma_tiles.cuh']) == FA.K1_TMA_EXTRA
    assert num('TMA_PLAN_LEN', fwd) == len(FA.rope_attention_qkv_plan(16, 291, 8,
                                                                       torch.bfloat16)['array'])
    assert 4 * num('TMA_GROUPS', fwd) * 32 == FA.K1_TMA_THREADS
    for name in ('wgmma_rope_attention_qkv_kernel', 'wgmma_rope_attention_sep_fwd_kernel',
                 'wgmma_plain_attention_kernel', 'hd_rope_attention_tma', 'hd_attention_tma'):
        assert name in fwd, name
    k4 = (_build.CSRC_DIR / 'bytenet_block_bwd.cu').read_text()
    env = {}   # each K4 constant in order, from the constants before it

    def k4_num(name):
        env[name] = eval(re.search(rf'constexpr int {name} = ([^;]+);', k4).group(1), {}, env)
        return env[name]
    assert k4_num('WGRAD_TARGET') == FB.K4_WGRAD_TARGET
    assert k4_num('WGRAD_MIN_ROWS') == FB.K4_WGRAD_MIN_ROWS
    assert k4_num('SUM_JOBS') == FB.K4_SUM_JOBS and k4_num('SUM_BLOCKS') == FB.K4_SUM_BLOCKS
    assert k4_num('TMA_BM') == FB.K4_TMA_BM and k4_num('TMA_BN') == FB.K4_TMA_BN
    k4_num('TMA_GROUP_WARPS')
    k4_num('TMA_CONSUMERS')
    assert k4_num('TMA_THREADS') == FB.K4_TMA_THREADS and k4_num('BOX') == FB.K4_BOX
    assert k4_num('TMA_MAX_SMEM') == FB.MAX_SMEM and k4_num('MAX_CLUSTER') == FB.MAX_CLUSTER
    assert k4_num('DATA_STAGES') == FB.K4_DATA_STAGES
    assert 'constexpr int WGRAD_STAGES[2] = {%d, %d};' % FB.K4_WGRAD_STAGES in k4
    assert k4_num('N_MAPS') == len(FB.bytenet_block_backward_plan(
        16, 152, 768, 384, 7, 1, torch.bfloat16)['tensor_maps'])
    assert k4_num('PLAN_LEN') == FB.K4_PLAN_LEN
    for name in ('wgmma_bytenet_bwd_data_kernel', 'wgmma_bytenet_bwd_wgrad_kernel',
                 'hd_bytenet_block_bwd_tma', 'hd_wgmma_trans_a_probe'):
        assert name in k4, name


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run the plain versions, whatever the plan."""
    rs = np.random.RandomState(0)
    qkv = torch.from_numpy(rs.randn(2, 17, 8 * 192).astype(np.float32)).bfloat16()
    from hudiff_tpu_torch.ops.rope import rope_tables
    cos, sin = rope_tables(64, 17)
    for path in ('wgmma', 'mma_sync'):
        plan = FA.rope_attention_qkv_plan(2, 17, 8, torch.bfloat16, path=path)
        assert torch.equal(FA.rope_attention_qkv_forward(qkv, cos, sin, 0.125, 8, plan=plan),
                           FA.rope_attention_qkv_reference(qkv, cos, sin, 0.125, 8))
        q, k, v = FA.split_qkv_heads(qkv, 8)
        plan = FA.rope_attention_qkv_plan(2, 17, 8, torch.bfloat16, path=path, layout='sep')
        for got, want in zip(
                FA.rope_attention_forward(q, k, v, cos, sin, 0.125, 8, True, plan=plan),
                FA.rope_attention_reference(q, k, v, cos, sin, 0.125, 8, True)):
            assert torch.equal(got, want)
        q4, k4, v4 = (t.reshape(2, 17, 8, 64) for t in (q, k, v))
        plan = FA.rope_attention_qkv_plan(2, 17, 8, torch.bfloat16, path=path, layout='blhd')
        assert torch.equal(FA.attention(q4, k4, v4, 0.125, plan=plan),
                           FA.attention_reference(q4, k4, v4, 0.125))
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        plan = FA.rope_attention_qkv_plan(2, 17, 8, torch.bfloat16, path=path, layout='bhld')
        assert torch.equal(FA.fused_attention(t(q4), t(k4), t(v4), 0.125, plan=plan),
                           t(FA.attention_reference(q4, k4, v4, 0.125)))


# -- on a card -----------------------------------------------------------------

BF16_RTOL = 2.0 ** -7
TOL = {'K1': {torch.float32: 1e-5, torch.bfloat16: 5e-3},
       'K2': {torch.float32: 2e-5, torch.bfloat16: 2.5e-2},
       'K3': {torch.float32: 1e-5, torch.bfloat16: 5e-3},
       'K5': {torch.float32: 1e-5, torch.bfloat16: 5e-3},
       'K7': {torch.float32: 1e-5, torch.bfloat16: 5e-3}}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (the CUDA kernels have no CPU mode)')
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        yield torch.device('cuda')


def _held(kernel, out, ref):
    diff = (out.float() - ref.float()).abs()
    if out.dtype == torch.float32:
        return diff.max().item() <= TOL[kernel][out.dtype]
    return (diff - BF16_RTOL * ref.float().abs()).max().item() <= TOL[kernel][out.dtype]


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('heads', HEADS)
@pytest.mark.parametrize('L', LENGTHS)
def test_k1_on_the_card(dev, L, heads, dtype):
    from hudiff_tpu_torch.ops.rope import rope_tables
    cos, sin = rope_tables(64, L, device=dev)
    g = torch.Generator().manual_seed(L + heads)
    for B in (1, 16, 64):
        qkv = torch.randn(B, L, heads * 192, generator=g).to(dev, dtype)
        out, out_f32, lse = FA.rope_attention_qkv_forward(qkv, cos, sin, 0.125, heads,
                                                          residuals=True)
        ref, ref_f32, ref_lse = FA.rope_attention_qkv_reference(qkv, cos, sin, 0.125, heads,
                                                                residuals=True)
        assert _held('K1', out, ref)
        assert torch.equal(out, FA.rope_attention_qkv(qkv, cos, sin, 0.125, heads))
        assert (lse - ref_lse).abs().max().item() <= 1e-3
        assert ((out_f32 - ref_f32).abs().max() / ref_f32.abs().max()).item() <= 1e-4
        if dtype is torch.bfloat16:   # the Hopper design: every split reads the same bits
            tiles = -(-L // 64)
            for split in range(1, tiles + 1):
                plan = FA.rope_attention_qkv_plan(B, L, heads, dtype, path='wgmma', split=split)
                assert torch.equal(out, FA.rope_attention_qkv_forward(
                    qkv, cos, sin, 0.125, heads, plan=plan))


@pytest.mark.cuda
@pytest.mark.parametrize('B,L', [(16, 17), (16, 152), (16, 291), (8, 384), (64, 291)])
def test_k5_k7_on_the_card(dev, B, L):
    """K5 and K7 in bf16 on both designs against their plain versions (with
    K5's residuals, as K1's are held); on each design K5 gives K1's bits on
    the merged input, residuals included, K7's two layouts give the same
    bits, and a call without the residuals or a repeat the same bits."""
    from hudiff_tpu_torch.ops.rope import rope_tables
    bf, heads = torch.bfloat16, 8
    cos, sin = rope_tables(64, L, device=dev)
    g = torch.Generator().manual_seed(5 * L + B)
    q, k, v = (torch.randn(B, L, heads * 64, generator=g).to(dev, bf) for _ in range(3))
    qkv = FA.merge_qkv_heads(q, k, v, heads)
    ref, ref_f32, ref_lse = FA.rope_attention_reference(q, k, v, cos, sin, 0.125, heads, True)
    q4, k4, v4 = (t.reshape(B, L, heads, 64) for t in (q, k, v))
    want = FA.attention_reference(q4, k4, v4, 0.125)
    bhld_in = [t.transpose(1, 2).contiguous() for t in (q4, k4, v4)]
    assert FA.rope_attention_qkv_plan(B, L, heads, bf, layout='sep')['path'] == 'wgmma'
    for path in ('wgmma', 'mma_sync'):
        plan = lambda layout: FA.rope_attention_qkv_plan(  # noqa: E731
            B, L, heads, bf, path=path, layout=layout)
        out, out_f32, lse = FA.rope_attention_forward(q, k, v, cos, sin, 0.125, heads, True,
                                                      plan=plan('sep'))
        assert _held('K5', out, ref), path
        assert ((out_f32 - ref_f32).abs().max() / ref_f32.abs().max()).item() <= 1e-4, path
        assert (lse - ref_lse).abs().max().item() <= 1e-3, path
        assert torch.equal(out, FA.rope_attention_forward(q, k, v, cos, sin, 0.125, heads,
                                                          plan=plan('sep')))
        k1 = FA.rope_attention_qkv_forward(qkv, cos, sin, 0.125, heads, True, plan=plan('qkv'))
        assert all(torch.equal(a, b) for a, b in zip((out, out_f32, lse), k1)), path
        blhd = FA.attention(q4, k4, v4, 0.125, plan=plan('blhd'))
        bhld = FA.fused_attention(*bhld_in, 0.125, plan=plan('bhld'))
        assert _held('K7', blhd, want), path
        assert torch.equal(bhld.transpose(1, 2), blhd), path
        assert torch.equal(blhd, FA.attention(q4, k4, v4, 0.125, plan=plan('blhd')))
    if B * heads >= 64:   # the defaults take the Hopper design: every split the same bits
        out = FA.rope_attention(q, k, v, cos, sin, 0.125, heads)
        blhd = FA.attention(q4, k4, v4, 0.125)
        for split in range(1, -(-L // 64) + 1):
            plan = lambda layout: FA.rope_attention_qkv_plan(  # noqa: E731
                B, L, heads, bf, split=split, layout=layout)
            assert torch.equal(out, FA.rope_attention_forward(q, k, v, cos, sin, 0.125, heads,
                                                              plan=plan('sep')))
            assert torch.equal(blhd, FA.attention(q4, k4, v4, 0.125, plan=plan('blhd')))
            assert torch.equal(blhd, FA.fused_attention(*bhld_in, 0.125,
                                                        plan=plan('bhld')).transpose(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize('B,L', [(16, 291), (64, 152), (8, 37)])
def test_hopper_k5_residuals_feed_k6(dev, B, L):
    """The Hopper K5 writing the residuals under autograd, K6 from them:
    the leaves' gradients are K6's given those residuals, within the limits
    of both plain backwards (the TPU kernel's arithmetic, and the kernels'
    own from the residuals)."""
    from hudiff_tpu_torch.ops.rope import rope_tables
    bf, heads = torch.bfloat16, 8
    assert FA.rope_attention_qkv_plan(B, L, heads, bf, layout='sep')['path'] == 'wgmma'
    cos, sin = rope_tables(64, L, device=dev)
    g = torch.Generator().manual_seed(7 * L + B)
    q, k, v, do = (torch.randn(B, L, heads * 64, generator=g).to(dev, bf) for _ in range(4))
    _, o32, lse = FA.rope_attention_forward(q, k, v, cos, sin, 0.125, heads, True)
    grads = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, heads, out=o32, lse=lse)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.rope_attention(*leaves, cos, sin, 0.125, heads).backward(do)
    ref = FA.rope_attention_backward_reference(q, k, v, cos, sin, do, 0.125, heads)
    twin = FA.rope_attention_backward_reference(q, k, v, cos, sin, do, 0.125, heads, o32, lse)
    for name, got, leaf, r, t in zip('qkv', grads, leaves, ref, twin):
        assert torch.equal(leaf.grad, got), name
        assert _held('K3', got, r) and _held('K3', got, t), name


@pytest.mark.cuda
def test_hopper_entries_from_a_fresh_thread(dev):
    """The Hopper K4, K5 and K6 launch where their tensor maps are the first
    CUDA work of a thread (autograd's backward thread, the first time its
    first kernel is one of them), with the bits of the same calls on the
    main thread."""
    import threading
    from hudiff_tpu_torch.ops.rope import rope_tables
    bf, heads, B, L = torch.bfloat16, 8, 16, 152
    cos, sin = rope_tables(64, L, device=dev)
    g = torch.Generator().manual_seed(11)
    q, k, v, do = (torch.randn(B, L, heads * 64, generator=g).to(dev, bf) for _ in range(4))
    _, o32, lse = FA.rope_attention_forward(q, k, v, cos, sin, 0.125, heads, True)
    want = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, heads, out=o32, lse=lse)
    got = {}

    xb, dyb = (torch.randn(B, L, 768, generator=g).to(dev, bf) for _ in range(2))
    from hudiff_tpu_torch.tools import bytenet_bwd_sweep as S
    params = S.block_params(768, 'relu', 2, dev, g)
    kw = dict(dilation=2, activation_name='relu')
    _, p, qq, st = FB._forward(xb, params, 2, 'relu', keep=True)
    assert FB.bytenet_block_backward_plan(B, L, 768, 384, 7, 2, bf)['path'] == 'wgmma'
    want_k4 = FB.bytenet_block_backward(xb, p, qq, *params, dyb, **kw, stats=st)

    def work():
        try:
            got['k4'] = FB.bytenet_block_backward(xb, p, qq, *params, dyb, **kw, stats=st)
            got['bwd'] = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, heads,
                                                    out=o32, lse=lse)
            got['fwd'] = FA.rope_attention_forward(q, k, v, cos, sin, 0.125, heads, True)
            torch.cuda.synchronize()
        except RuntimeError as e:
            got['error'] = str(e)

    thread = threading.Thread(target=work)
    thread.start()
    thread.join()
    assert 'error' not in got, got.get('error')
    assert all(torch.equal(a, b) for a, b in zip(got['bwd'], want))
    assert all(torch.equal(a, b) for a, b in zip(got['fwd'][1:], (o32, lse)))
    assert all(torch.equal(a, b) for a, b in zip(got['k4'], want_k4))


def _row_stats(z):
    """f32 (mean, 1/sigma) of z's rows, the fast variance clamped at 0."""
    zf = z.float()
    mu = zf.mean(-1)
    return torch.stack((mu, torch.rsqrt(((zf * zf).mean(-1) - mu * mu).clamp_min(0) + 1e-6)), -1)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('D,K', TOWERS)
def test_k2_on_the_card(dev, D, K, dtype):
    """K2 on every design that takes the shape against the plain version
    (the K2 limits) at L = 152 and 139, dilations 1, 32 and 2, B*L a
    multiple of 128 and not (16 x 139, 64 x 139), clusters of 3 on the
    768/384 tower. On each bf16 design: with keep on and off the same y, a
    repeat the same bits, the LayerNorm statistics of x the same bits on
    both Hopper designs (they sum x's rows in one order) and those of p and
    q within f32 rounding of the statistics of the design's own p and q
    (the designs accumulate the products in other orders, so p and q
    themselves may differ in their last bits); and the plan's call
    captured in a CUDA graph (F2 and F3 launched to start under the launch
    before them) replays to the eager call's bits."""
    from hudiff_tpu_torch.ops.bytenet import ByteNetBlock
    H = D // 2
    g = torch.Generator().manual_seed(D + K)
    act = 'gelu' if D != 768 else 'relu'
    for B, L, dil in ((16, 152, 1), (16, 139, 32), (64, 139, 32), (128, 152, 2)):
        torch.manual_seed(D + dil)   # the module's own initialisation, as chip_smoke.py's
        blk = ByteNetBlock(D, H, K, dilation=dil, activation=act)
        with torch.no_grad():
            for ln in (blk.ln1, blk.ln2, blk.ln3):
                ln.weight.add_(0.1 * torch.randn(ln.weight.shape, generator=g))
                ln.bias.add_(0.1 * torch.randn(ln.bias.shape, generator=g))
        params = [t.detach() for t in (blk.ln1.weight, blk.ln1.bias, blk.fc1.weight,
                                       blk.fc1.bias, blk.ln2.weight, blk.ln2.bias,
                                       blk.conv.weight, blk.conv.bias, blk.ln3.weight,
                                       blk.ln3.bias, blk.fc2.weight, blk.fc2.bias)]
        args = [t.to(dev, dtype) if t.dim() >= 2 else t.to(dev) for t in params]
        x = torch.randn(B, L, D, generator=g).to(dev, dtype)
        ref = FB.bytenet_block_reference(x, *args, dilation=dil, activation_name=act)
        y = FB.bytenet_block(x, *args, dilation=dil, activation_name=act)
        assert _held('K2', y, ref)
        if dtype is not torch.bfloat16:
            continue
        chosen = FB.bytenet_block_plan(B, L, D, H, K, dil, dtype)['path']
        x_stats = {}
        for path in FB.K2_PATHS[:3]:
            try:
                plan = FB.bytenet_block_plan(B, L, D, H, K, dil, dtype, path=path)
            except ValueError:   # the Hopper designs take widths that are multiples of 128
                continue
            y2, p, q, st = FB._forward(x, args, dil, act, keep=True, plan=plan)
            assert _held('K2', y2, ref), path
            assert torch.equal(y2, FB._forward(x, args, dil, act, keep=False, plan=plan)[0])
            assert torch.equal(y2, FB._forward(x, args, dil, act, keep=True, plan=plan)[0])
            assert st.shape == (3, B, L, 2) and bool(torch.isfinite(st).all()), path
            for k, z in enumerate((x, p, q)):
                want = _row_stats(z)
                assert ((st[k] - want).abs() <= 1e-5 + 1e-4 * want.abs()).all(), (path, k)
            if path == chosen:
                assert torch.equal(y2, y)
            if path in FB.K2_HOPPER:
                x_stats[path] = st[0]
        if len(x_stats) == 2:
            assert torch.equal(x_stats['wgmma'], x_stats['wgmma128'])
        # the plan's call as the graph sampler runs it: captured, then replayed
        call = lambda: FB.bytenet_block(x, *args, dilation=dil, activation_name=act)  # noqa: E731
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            yg = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(yg, y)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', DTYPES, ids=str)
@pytest.mark.parametrize('heads', HEADS)
@pytest.mark.parametrize('L', (291, 152, 100, 17))
def test_k3_k6_on_the_card(dev, L, heads, dtype):
    """K3 and K6 from K1's residuals on every design that takes the shape,
    against both plain versions (the TPU kernel's arithmetic and the
    kernels' own from the residuals); a repeat and every split and number
    of warpgroups of the Hopper design give the same bits, and K6 gives
    K3's bits on the split q, k, v."""
    from hudiff_tpu_torch.ops.rope import rope_tables
    cos, sin = rope_tables(64, L, device=dev)
    g = torch.Generator().manual_seed(3 * L + heads)
    for B in (2, 16, 64):
        qkv = torch.randn(B, L, heads * 192, generator=g).to(dev, dtype)
        do = torch.randn(B, L, heads * 64, generator=g).to(dev, dtype)
        _, o32, lse = FA.rope_attention_qkv_forward(qkv, cos, sin, 0.125, heads, residuals=True)
        q, k, v = (t.contiguous() for t in FA.split_qkv_heads(qkv, heads))
        ref = FA.rope_attention_qkv_backward_reference(qkv, cos, sin, do, 0.125, heads)
        twin = FA.rope_attention_qkv_backward_reference(qkv, cos, sin, do, 0.125, heads, o32, lse)
        chosen = FA.rope_attention_qkv_backward(qkv, cos, sin, do, 0.125, heads, out=o32, lse=lse)
        for path in (('wgmma', 'mma_sync') if dtype is torch.bfloat16 else ('fma',)):
            plan = FA.rope_attention_bwd_plan(B, L, heads, dtype, path=path)
            got = FA.rope_attention_qkv_backward(qkv, cos, sin, do, 0.125, heads, out=o32,
                                                 lse=lse, plan=plan)
            again = FA.rope_attention_qkv_backward(qkv, cos, sin, do, 0.125, heads, out=o32,
                                                   lse=lse, plan=plan)
            sep = FA.rope_attention_backward(
                q, k, v, cos, sin, do, 0.125, heads, out=o32, lse=lse,
                plan=FA.rope_attention_bwd_plan(B, L, heads, dtype, path=path, layout='sep'))
            assert _held('K3', got, ref) and _held('K3', got, twin), path
            assert torch.equal(got, again) and torch.equal(FA.merge_qkv_heads(*sep, heads), got)
            if path == FA.rope_attention_bwd_plan(B, L, heads, dtype)['path']:
                assert torch.equal(chosen, got)
            if path == 'wgmma':
                tiles = -(-L // 64)
                for split in (x for x in range(1, tiles + 1)
                              if FA._bwd_tma_smem(tiles, x, L) <= FA.MAX_SMEM):
                    for groups in FA.K3_GROUPS:
                        other = FA.rope_attention_bwd_plan(B, L, heads, dtype, split=split,
                                                           groups=groups)
                        assert torch.equal(got, FA.rope_attention_qkv_backward(
                            qkv, cos, sin, do, 0.125, heads, out=o32, lse=lse, plan=other))


@pytest.mark.cuda
def test_wgmma_transposed_a_alone(dev):
    """One wgmma m64n128k16 chain with the transpose-A bit (A M-major in
    shared memory, as the weight gradients read X^T) against torch.matmul."""
    g = torch.Generator().manual_seed(23)
    for _ in range(3):
        a = torch.randn(64, 64, generator=g).to(dev, torch.bfloat16)
        b = torch.randn(64, 128, generator=g).to(dev, torch.bfloat16)
        got = FB.wgmma_trans_a_probe(a, b)
        want = torch.matmul(a.float().t(), b.float())
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


K4_EDGE = [(2, 139, 768, 'relu', 32), (3, 37, 256, 'gelu', 4), (2, 152, 512, 'gelu', 1),
           (1, 100, 1024, 'gelu', 2)]


@pytest.mark.cuda
@pytest.mark.parametrize('B,L,D,act,dil', K4_EDGE)
def test_k4_on_the_card(dev, B, L, D, act, dil):
    """The Hopper K4 and mma.sync at the edge shapes (L = 139, dilation 32,
    B*L not a multiple of 64 or 128, a cluster of 8), with and without K2's
    statistics, against the plain version given the same, within K4's
    limits (dx: 2**-7 |ref| + 1.5e-2; gradients 2e-3 max |ref|); a repeat
    gives the same bits, five launches a call."""
    from hudiff_tpu_torch.tools import bytenet_bwd_sweep as S
    H, K, bf = D // 2, 7, torch.bfloat16
    g = torch.Generator().manual_seed(B * L + D + dil)
    params = S.block_params(D, act, dil, dev, g)
    x, dy = (torch.randn(B, L, D, generator=g).to(dev, bf) for _ in range(2))
    kw = dict(dilation=dil, activation_name=act)
    _, p, q, st = FB._forward(x, params, dil, act, keep=True)
    chosen_path = FB.bytenet_block_backward_plan(B, L, D, H, K, dil, bf)['path']
    for stats in (st, None):
        ref = FB.bytenet_block_backward_reference(x, p, q, *params, dy, **kw, stats=stats)
        chosen = FB.bytenet_block_backward(x, p, q, *params, dy, **kw, stats=stats)
        for path in ('wgmma', 'mma_sync'):
            plan = FB.bytenet_block_backward_plan(B, L, D, H, K, dil, bf, path=path)
            before = FB.bwd_launches
            got = FB.bytenet_block_backward(x, p, q, *params, dy, **kw, stats=stats, plan=plan)
            again = FB.bytenet_block_backward(x, p, q, *params, dy, **kw, stats=stats, plan=plan)
            torch.cuda.synchronize()
            assert FB.bwd_launches == before + 10
            rec = S.held(got, ref)
            assert rec['held'], (path, stats is None, rec)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), path
            if path == chosen_path:
                assert all(torch.equal(a, b) for a, b in zip(got, chosen))


def test_bwd_sweep_shapes_and_refusal_without_a_card(monkeypatch):
    """The backward's timing tool covers every shape the paths give K3 (B
    in 16, 32, 128, 512; L = 291, 152 and the short lengths; 8, 4 and 2
    heads) and, without a card, refuses with exit code 2."""
    from hudiff_tpu_torch.tools import attention_bwd_sweep as S
    assert set(S.PATH_SHAPES) == {(B, L, H) for B in BWD_BATCHES for L in BWD_LENGTHS
                                  for H in HEADS}
    assert set(S.MAIN_SHAPES) <= set(S.PATH_SHAPES)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert S.main(['--shapes', 'main']) == 2


def test_k4_sweep_shapes_and_refusal_without_a_card(monkeypatch):
    """K4's timing tool covers the shapes the training paths give it (the
    Ab towers at B = 16, 32 and 128, L = 152 and 139; the Nb towers at B =
    512, L = 152), holds the card tests' limits and, without a card, refuses
    with exit code 2."""
    from hudiff_tpu_torch.tools import bytenet_bwd_sweep as S
    assert set(S.PATH_SHAPES) == {(B, L, 768, 'relu') for B in (16, 32, 128) for L in (152, 139)} \
        | {(B, L, 256, 'gelu') for B in (16, 32, 128) for L in (152, 139)} \
        | {(512, 152, 512, 'gelu'), (512, 152, 256, 'gelu')}
    assert set(S.MAIN_SHAPES) <= set(S.PATH_SHAPES) and S.DILATIONS == DILATIONS
    assert (S.DX_ATOL, S.GRAD_RTOL) == (1.5e-2, 2e-3)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert S.main(['--shapes', 'main']) == 2


def test_k4_sweep_time_designs_on_the_cpu(monkeypatch):
    """The timing that the tool and chip_smoke.py's K4 records share: each
    design is held before it is timed, ``device_ms`` is the plan's design's,
    and an output off its limits stops it before its design is timed
    (graph_ms stubbed, CPU tensors take the plain version: no card)."""
    from hudiff_tpu_torch.tools import bytenet_bwd_sweep as S
    timed = []

    def graph_ms(fn):
        fn()
        timed.append(fn)
        return float(len(timed))

    monkeypatch.setattr(S, 'graph_ms', graph_ms)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda: None)
    g = torch.Generator().manual_seed(5)
    params = S.block_params(256, 'gelu', 2, torch.device('cpu'), g)
    x, dy = (torch.randn(2, 19, 256, generator=g).bfloat16() for _ in range(2))
    _, p, q, _ = FB._forward(x, params, 2, 'gelu', keep=True)
    kw = dict(dilation=2, activation_name='gelu')
    ref = FB.bytenet_block_backward_reference(x, p, q, *params, dy, **kw)
    call = lambda plan: FB.bytenet_block_backward(x, p, q, *params, dy, **kw,  # noqa: E731
                                                  plan=plan)
    rec = S.time_designs(call, ref, (2, 19, 256, 128, 2), launches=False)
    # 38 rows of the 256/128 tower: the plan keeps mma.sync, timed second
    assert rec['path'] == 'mma_sync' and rec['device_ms'] == rec['device_ms_mma_sync'] == 2.0
    assert rec['device_ms_wgmma'] == 1.0 and rec['held_wgmma'] and rec['held_mma_sync']
    assert rec['dx_excess_wgmma'] <= 0.0 and rec['grad_rel_err_mma_sync'] == 0.0
    timed.clear()
    off = [t.clone() for t in ref]
    off[3] = off[3] * 1.01
    with pytest.raises(RuntimeError, match='wgmma design'):
        S.time_designs(call, off, (2, 19, 256, 128, 2), launches=False)
    assert not timed


def test_k2_sweep_shapes_and_refusal_without_a_card(monkeypatch):
    """K2's timing tool covers the shapes the paths give it (the Ab towers
    at B = 1, 16, 32, 64 and 128, L = 152 and 139; the Nb towers at B = 1,
    16, 64, 128 and 512, L = 152), every design the plan has, the K2 limit,
    and, without a card, refuses with exit code 2."""
    from hudiff_tpu_torch.tools import bytenet_fwd_sweep as S
    ab = {(B, L, D, act) for B in (1, 16, 32, 64, 128) for L in (152, 139)
          for D, act in ((768, 'relu'), (256, 'gelu'))}
    nb = {(B, 152, D, 'gelu') for B in (1, 16, 64, 128, 512) for D in (512, 256)}
    assert set(S.PATH_SHAPES) == ab | nb and len(S.PATH_SHAPES) == len(ab | nb)
    assert set(S.MAIN_SHAPES) <= set(S.PATH_SHAPES) and S.DILATIONS == DILATIONS
    assert S.DESIGNS == FB.K2_PATHS[:3] and S.BF16_ATOL == TOL['K2'][torch.bfloat16]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert S.main(['--shapes', 'main']) == 2


def test_k2_sweep_time_designs_on_the_cpu(monkeypatch):
    """The timing that the tool and chip_smoke.py's K2 records share: each
    design is held before it is timed and checked to repeat to the same
    bits, ``device_ms`` is the plan's design's, a tuning variant whose plan
    is its design's own is not timed twice, the composition is timed; an
    output off the limit stops it before its design is timed (graph_ms
    stubbed, CPU tensors take the plain version: no card)."""
    from hudiff_tpu_torch.tools import bytenet_fwd_sweep as S
    timed = []

    def graph_ms(fn):
        fn()
        timed.append(fn)
        return float(len(timed))

    monkeypatch.setattr(S, 'graph_ms', graph_ms)
    monkeypatch.setattr(torch.cuda, 'synchronize', lambda: None)
    g = torch.Generator().manual_seed(7)
    params = [t.bfloat16() if t.dim() >= 2 else t
              for t in S.block_params(256, 'gelu', 2, torch.device('cpu'), g)]
    x = torch.randn(2, 19, 256, generator=g).bfloat16()
    ref = FB.bytenet_block_reference(x, *params, dilation=2, activation_name='gelu')
    seen = []

    def held(name, y):
        seen.append(name)
        assert S.excess(y, ref) <= S.BF16_ATOL

    call = lambda plan: FB._forward(x, params, 2, 'gelu', keep=False, plan=plan)[0]  # noqa: E731
    lib = S.composition_params(params, torch.bfloat16)
    comp = lambda: S.block_composition(x, lib, 2, 'gelu')  # noqa: E731
    assert S.excess(comp(), ref) <= S.BF16_ATOL   # the yardstick computes the same function
    rec = S.time_designs(call, held, (2, 19, 256, 128, 7, 2), tuning=True, composition=comp)
    # 38 rows: the 64-row design, with 64-column tiles on every launch (few tiles)
    assert rec['path'] == 'wgmma' and rec['device_ms'] == rec['device_ms_wgmma'] == 1.0
    # (wgmma_bn64 is the design's own plan here, wgmma128_bn128 the 128-row one's:
    # each plan timed once; 128 columns are no 256-column tiles)
    assert seen == ['wgmma', 'wgmma128', 'mma_sync', 'wgmma_bn128', 'wgmma_nopdl',
                    'wgmma128_nopdl']
    assert rec['library_device_ms'] == len(timed) == 7
    rec = S.time_designs(call, held, (2, 19, 256, 128, 7, 2))
    assert set(rec) == {'path', 'device_ms', 'device_ms_wgmma', 'device_ms_wgmma128',
                        'device_ms_mma_sync'}
    timed.clear()

    def off(name, y):
        raise RuntimeError(f'{name} off')

    with pytest.raises(RuntimeError, match='wgmma off'):
        S.time_designs(call, off, (2, 19, 256, 128, 7, 2))
    assert not timed


@pytest.mark.parametrize('layout', ('qkv', 'sep', 'blhd', 'bhld'))
def test_fwd_sweep_calls_on_the_cpu(layout):
    """The forward sweep's call for each layout gives the plain version's
    output on CPU tensors, and its SDPA inputs compute the same function."""
    import torch.nn.functional as F
    from hudiff_tpu_torch.ops.rope import rope_tables
    from hudiff_tpu_torch.tools import attention_fwd_sweep as S
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 17, 8 * 64, generator=g).bfloat16() for _ in range(3))
    cos, sin = rope_tables(64, 17)
    call, ref, sdpa = S._calls(layout, q, k, v, cos, sin, 0.125, 8)
    for path in ('wgmma', 'mma_sync'):
        assert torch.equal(call(FA.rope_attention_qkv_plan(2, 17, 8, torch.bfloat16, path=path,
                                                           layout=layout), False), ref)
    assert all(t.shape == (2, 8, 17, 64) for t in sdpa)
    got = F.scaled_dot_product_attention(*(t.float() for t in sdpa), scale=0.125)
    want = ref.float().reshape(2, 17, 8, 64).transpose(1, 2)
    assert (got - want).abs().max().item() <= 2e-2


def test_fwd_sweep_shapes_and_refusal_without_a_card(monkeypatch):
    """The forward's timing tool covers the batches, lengths and heads the
    paths and entry points give K1, K5 and K7, in every layout the plan
    has, and, without a card, refuses with exit code 2."""
    from hudiff_tpu_torch.tools import attention_fwd_sweep as S
    assert set(S.PATH_SHAPES) == {(B, L, H) for B in BATCHES for L in (291, 152)
                                  for H in HEADS}
    assert set(S.MAIN_SHAPES) <= set(S.PATH_SHAPES)
    assert S.LAYOUTS == tuple(FA.FWD_LAYOUTS)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert S.main(['--shapes', 'main']) == 2


@pytest.mark.parametrize('layout', ('qkv', 'sep', 'blhd', 'bhld'))
def test_fwd_sweep_time_designs_on_the_cpu(monkeypatch, layout):
    """The timing that the tool and chip_smoke.py's K1, K5 and K7 records
    share: each design's output is held before it is timed, each design is
    timed (with the residuals where asked), ``device_ms`` is the plan's
    design's and SDPA is timed on the inputs given; an output that is not
    held stops it before its design is timed (graph_ms stubbed: no card)."""
    from hudiff_tpu_torch.ops.rope import rope_tables
    from hudiff_tpu_torch.tools import attention_fwd_sweep as S
    timed = []

    def graph_ms(fn):
        fn()
        timed.append(fn)
        return float(len(timed))

    monkeypatch.setattr(S, 'graph_ms', graph_ms)
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(2, 17, 8 * 64, generator=g).bfloat16() for _ in range(3))
    cos, sin = rope_tables(64, 17)
    call, ref, sdpa = S._calls(layout, q, k, v, cos, sin, 0.125, 8)
    seen = []

    def held(path, out):
        seen.append(path)
        assert torch.equal(out, ref)

    res = layout in ('qkv', 'sep')
    rec = S.time_designs(call, held, (2, 17), 8, layout, lambda: sdpa, 0.125, residuals=res)
    assert seen == ['wgmma', 'mma_sync'] and rec['path'] == 'mma_sync'   # 16 (b, h) pairs
    keys = {f'device_ms_{p}{r}' for p in ('wgmma', 'mma_sync') for r in ('', '_res')[:1 + res]}
    assert keys | {'path', 'device_ms', 'library_device_ms'} == set(rec)
    assert rec['device_ms'] == rec['device_ms_mma_sync'] and len(timed) == len(keys) + 1

    def off(path, out):
        raise RuntimeError(f'{path} off')

    timed.clear()
    with pytest.raises(RuntimeError, match='wgmma off'):
        S.time_designs(call, off, (2, 17), 8, layout, lambda: sdpa, 0.125)
    assert not timed


def test_build_keeps_nvcc_output_beside_the_library(monkeypatch, tmp_path):
    """nvcc's output is kept beside the library it built, and a later
    process that finds the library built reads ptxas's report from there
    (a stand-in compiler: no nvcc here)."""
    import sys
    nvcc = tmp_path / 'nvcc'
    calls = tmp_path / 'calls'
    nvcc.write_text(f'#!{sys.executable}\n'
                    'import sys\n'
                    f'open({str(calls)!r}, "a").write("x")\n'
                    'open(sys.argv[sys.argv.index("-o") + 1], "w").write("lib")\n'
                    'print("ptxas info    : Used 128 registers")\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, 'nvcc_path', lambda: str(nvcc))
    monkeypatch.setattr(_build, 'BUILD_LOGS', {})
    _build.build_all(['rope_attention'])
    assert _build.library_path('rope_attention').read_text() == 'lib'
    assert 'Used 128 registers' in _build.log_path('rope_attention').read_text()
    assert _build.log_path('rope_attention').parent == _build.library_path('rope_attention').parent
    assert sorted(p.name for p in (tmp_path / 'build').iterdir()) == sorted(
        [_build.library_path('rope_attention').name, _build.log_path('rope_attention').name])
    monkeypatch.setattr(_build, 'BUILD_LOGS', {})   # a later process: built, not rebuilt
    assert _build.build_all(['rope_attention']) == {'rope_attention': 0.0}
    assert 'Used 128 registers' in _build.BUILD_LOGS['rope_attention']
    assert calls.read_text() == 'x'


def test_hopper_gate_reads_every_librarys_log(monkeypatch):
    """chip_smoke.py's hopper_kernels gate holds HOPPER_INSTANTIATIONS
    instantiations with HGMMA and UTMALDG and no HMMA, and fails on a
    serialized wgmma in any kept log or on a library without one, whether
    or not this process built it (cuobjdump stubbed: no card)."""
    import types
    import chip_smoke
    libs = chip_smoke.HOPPER_LIBRARIES
    assert 'bytenet_block_bwd' in libs
    counts = {f'wgmma_kernel_{i}': {'HGMMA': 4, 'UTMALDG': 2, 'HMMA': 0}
              for i in range(chip_smoke.HOPPER_INSTANTIATIONS)}
    monkeypatch.setattr(chip_smoke, 'sass_counts',
                        lambda path, ops, symbols: counts if 'rope_attention-' in path.name
                        else {})
    clean = 'ptxas info    : Used 128 registers\n'
    fake = lambda logs: types.SimpleNamespace(  # noqa: E731
        BUILD_LOGS=logs, library_path=lambda lib: _build.BUILD_DIR / f'{lib}-0.so')
    rec = chip_smoke.hopper_build_record(fake({lib: clean for lib in libs}))
    assert rec['wgmma_serialized'] == [] and rec['no_build_log'] == []
    warn = ("ptxas warning : (C7515) Potential Performance Loss: wgmma.mma_async instructions "
            "are serialized due to ... in the function 'x'\n")
    for logs in ({lib: clean for lib in libs[:2]},
                 {**{lib: clean for lib in libs}, 'bytenet_block': clean + warn}):
        with pytest.raises(SystemExit):
            chip_smoke.hopper_build_record(fake(logs))
    counts['wgmma_kernel_0']['HMMA'] = 1
    with pytest.raises(SystemExit):
        chip_smoke.hopper_build_record(fake({lib: clean for lib in libs}))
