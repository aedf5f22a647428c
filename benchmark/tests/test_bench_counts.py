"""The yardstick's counts at one Ab and one Nb shape, against values worked
by hand."""
import json
from pathlib import Path

import pytest

from benchmark import yardstick as Y

ROOT = Path(__file__).resolve().parents[2]
AB = json.loads((ROOT / 'benchmark/configs/hudiff_ab.json').read_text())
NB = json.loads((ROOT / 'benchmark/configs/hudiff_nb.json').read_text())


def test_conv_taps_leave_out_the_padding():
    # K = 7, dilation 1, L = 152: 7 x 152 rows less 3 + 2 + 1 + 0 + 1 + 2 + 3 on the padding
    assert Y.conv_taps(152, 7, 1) == 1052
    # dilation 32, L = 139: offsets 0, +-32, +-64, +-96 read 139, 107, 75, 43 rows each
    assert Y.conv_taps(139, 7, 32) == 139 + 2 * (107 + 75 + 43)


def test_dilations():
    assert Y.dilations(6, 128) == [1, 2, 4, 8, 16, 32]


def test_bytenet_block_ab_aa_tower():
    # B = 16, L = 152, D = 256, H = 128, K = 7, dilation 1:
    # 2 x 16 x (152 x 256 x 128 + 1052 x 128 x 128 + 152 x 128 x 256)
    flops, nbytes = Y.bytenet_fwd(16, 152, 256, 128, 7, 1)
    assert flops == 2 * 16 * (4_980_736 + 17_235_968 + 4_980_736) == 870_318_080
    # x and y in bf16, 2 x 2 x 16 x 152 x 256; the weights in bf16,
    # 2 x (32768 + 114688 + 32768); LayerNorms and biases in f32, 4 x (768 + 768)
    assert nbytes == 2 * 2 * 16 * 152 * 256 + 2 * 180_224 + 4 * 1536
    bwd_flops, _ = Y.bytenet_bwd(16, 152, 256, 128, 7, 1)
    assert bwd_flops == 2 * flops


def test_attention_ab_and_nb():
    # q k^T and p v: 4 L^2 d a head, no rotation products
    assert Y.attention_fwd(1, 291, 8, 64)[0] == 4 * 8 * 291 * 291 * 64 == 173_426_688
    assert Y.attention_bwd(1, 291, 8, 64)[0] == 10 * 8 * 291 * 291 * 64
    assert Y.attention_fwd(16, 152, 8, 64) == (4 * 16 * 8 * 152 * 152 * 64,
                                               2 * 16 * 152 * (3 * 512 + 512))


def test_model_flops():
    # the full-width Ab forward at B = 1: 17.99 GFLOP (utils/flops.py)
    assert Y.model_flops(AB, 'pair', 1, 152, 139) == pytest.approx(17.99e9, rel=1e-3)
    # Nb at B = 1: the towers 2 x 6 blocks at 256 and 512 over 152 rows, the
    # attention stack at 512 over 152, embedders and decoder
    stages = Y.stage_flops(NB, 'heavy', 1, 152, 139)
    assert stages['attention_core'] == 10 * 4 * 152 * 152 * 512
    assert stages['decoder'] == 2 * 152 * 512 * 23
    assert Y.model_flops(NB, 'heavy', 2, 152, 139, backward=True) == \
        6 * Y.model_flops(NB, 'heavy', 1, 152, 139)


def test_calls_of_a_forward():
    assert len(Y.bytenet_calls(AB, 'pair', 4, 152, 139)) == 24
    assert len(Y.bytenet_calls(NB, 'heavy', 4, 152, 139)) == 12
    assert len(Y.attention_calls(AB, 4)) == 10


def test_added_time_charges_overlap_once():
    assert Y.added([(0, 10), (5, 12), (20, 25), (21, 22)]) == [10, 2, 5, 0]


def test_groups():
    k2 = 'void (anonymous namespace)::wgmma_wide_bytenet_fwd_gemm_kernel<3, 128>'
    assert Y.group_of(k2) == 'K2'
    assert Y.group_of('void wgmma_bytenet_bwd_wgrad_kernel') == 'K4'
    assert Y.group_of('void wgmma_rope_attention_qkv_kernel<1>') == 'K1'
    assert Y.group_of('void rope_attention_bwd_prep_kernel') == 'K3'
    assert Y.group_of('nvjet_tst_128x192_64x5_2x1_v_bz_coopB_bias_TNN') == 'cublas'
    assert Y.group_of('vectorized_layer_norm_kernel') == 'other'


def test_abnativ_flops():
    hp = json.loads((ROOT / 'benchmark/data/abnativ.json').read_text())['hparams']
    # 74 positions after the stride-2 embedding: conv 2 x 74 x 21 x 4 x 128 (twice, with the
    # transposed one), 8 blocks of 2 x 74 x (3 x 128^2 + 2 x 74 x 128 + 128^2 + 2 x 128 x 256),
    # the codebook 2 x 74 x (2 x 128 x 32 + 32 x 512)
    assert Y.abnativ_flops(hp, 1) == 2 * 1_591_296 + 8 * 22_202_368 + 3_637_248


@pytest.mark.parametrize('trace, launched, faults', [
    ({'K1': 10, 'K2': 216}, {'K1': 10, 'K2': 216, 'K3': 0, 'K4': 0}, 0),
    ({'K1': 10, 'K2': 215}, {'K1': 10, 'K2': 216, 'K3': 0, 'K4': 0}, 1),   # a kernel unnamed
    ({'K1': 10, 'K2': 215}, {'K1': 10, 'K2': 215, 'K3': 0, 'K4': 0}, 1),   # not per call
    ({'K1': 10, 'K2': 216, 'K3': 3}, {'K1': 10, 'K2': 216, 'K3': 3, 'K4': 0}, 1),  # no calls
    ({'K2': 216}, {'K1': 0, 'K2': 216, 'K3': 0, 'K4': 0}, 1)])              # calls, no kernel
def test_launch_faults(trace, launched, faults):
    from benchmark.harness import Trace, launch_faults
    work = {'attention_fwd': Y.attention_calls(AB, 1),
            'bytenet_fwd': Y.bytenet_calls(AB, 'pair', 1, 152, 139)}
    got = launch_faults(Trace(1.0, 0.5, {}, trace, [], []), launched, work)
    assert len(got) == faults, got
