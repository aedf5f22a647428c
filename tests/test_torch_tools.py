"""The breakdown tools (hudiff_tpu_torch/tools/train_breakdown.py and
perf_breakdown.py) at test size on the CPU: the JSON each prints, every
section's rows, the FLOP counts from utils/flops.py, and the profiled
window: the step's (or forward's) CPU ms by op group and the time between
ops sum to the window, and no group exceeds it. On the card the same
sections read CUDA events and device kernels (chip_smoke.py runs both
tools at full width).
"""
import json

import pytest
import torch

from hudiff_tpu_torch.models.denoiser import DenoiserConfig
from hudiff_tpu_torch.tools import perf_breakdown as PB
from hudiff_tpu_torch.tools import train_breakdown as TB
from hudiff_tpu_torch.utils import flops as F

RATE_KEYS = {'ms', 'gflops', 'tflops_per_sec'}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _covers(window):
    groups = window['cpu_ms_by_group']
    assert set(groups) == {'matmul', 'other'} and min(groups.values()) > 0
    assert window['unattributed_ms'] >= 0
    total = sum(groups.values()) + window['unattributed_ms']
    assert total == pytest.approx(window['window_ms'], rel=1e-3)
    assert window['window_ms'] <= window['host_wall_ms'] * 1.01
    ops = window['other_top_ops']
    assert ops and all(o['cpu_ms'] > 0 for o in ops)
    assert sum(o['cpu_ms'] for o in ops) <= groups['other'] * (1 + 1e-6)


@pytest.mark.parametrize('nano', [False, True])
def test_train_breakdown(nano, capsys):
    argv = ['--device', 'cpu', '--test-size', '--sweep', '2', '--parts-batch', '2',
            '--reps', '1', '--windows', '1'] + (['--nano'] if nano else [])
    out = TB.main(argv)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    assert out['stack'] == ('nano' if nano else 'pair') and out['device'] == 'cpu'
    kind = 'heavy' if nano else 'pair'
    cfg = TB.model_config(nano, True)
    step = out['step_sweep']['2']
    assert RATE_KEYS | {'steps_per_sec'} <= set(step) and 'mfu_pct' not in step
    assert step['gflops'] == F.denoiser_model_flops(cfg, 2, kind=kind, backward=True) / 1e9
    parts = out['parts_B2']
    assert set(parts) == {'fwd_eval', 'fwd_train', 'fwd_bwd_train', 'fwd_bwd_nodrop', 'step'}
    assert all(RATE_KEYS <= set(v) and v['ms'] > 0 for v in parts.values())
    assert parts['fwd_eval']['gflops'] == F.denoiser_model_flops(cfg, 2, kind=kind) / 1e9
    stages = out['stages_B2']
    assert set(stages) == {f'{s}_{p}' for s in ('aa_towers', 'dual_towers', 'self_att')
                           for p in ('fwd', 'fwd_bwd')}
    for s in ('aa_towers', 'dual_towers', 'self_att'):
        assert stages[f'{s}_fwd_bwd']['gflops'] > 2 * stages[f'{s}_fwd']['gflops']
    _covers(out['profile_B2'])


def test_perf_breakdown(capsys):
    out = PB.main(['--device', 'cpu', '--test-size', '--batch', '2', '--reps', '1',
                   '--windows', '1'])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    rows = out['stages']
    assert set(rows) == {'full_forward', 'aa_conv_towers', 'dual_conv_towers',
                         'self_att_stack', 'embedders'}
    assert all(RATE_KEYS <= set(v) and v['ms'] > 0 for v in rows.values())
    stages = F.denoiser_stage_flops(DenoiserConfig().test_size(), 2, kind='pair')
    assert rows['full_forward']['gflops'] == pytest.approx(sum(stages.values()) / 1e9)
    assert rows['self_att_stack']['gflops'] == pytest.approx(
        (stages['self_att'] + stages['attention_core']) / 1e9)
    assert out['stage_sum_ms'] == pytest.approx(sum(
        v['ms'] for k, v in rows.items() if k != 'full_forward'))
    _covers(out['profile_full_forward'])


def test_kernel_groups():
    assert TB.kernel_group('void rope_attention_qkv_kernel<1>') == 'K1'
    assert TB.kernel_group('bytenet_fwd_gemm_kernel<...>') == 'K2'
    assert TB.kernel_group('rope_attention_bwd_prep_kernel') == 'K3'
    assert TB.kernel_group('bytenet_bwd_dgrad_kernel') == 'K4'
    assert TB.kernel_group('sm90_xmma_gemm_bf16bf16_bf16f32') == 'cublas'
    assert TB.kernel_group('void at::native::vectorized_elementwise_kernel') == 'other'


def test_added_ms_charges_overlapped_kernels_once():
    """A kernel that starts under the previous one's tail (programmatic
    dependent launch) is charged from that kernel's end; one that overlaps
    none, its duration; one inside another, nothing; the values sum to the
    time at least one kernel ran (µs in, ms out)."""
    from types import SimpleNamespace
    from hudiff_tpu_torch.tools import added_ms
    ev = lambda s, e: SimpleNamespace(time_range=SimpleNamespace(start=s, end=e))  # noqa: E731
    kernels = [ev(0, 100), ev(60, 250), ev(240, 400), ev(500, 520), ev(505, 510)]
    assert added_ms(kernels) == [0.1, 0.15, 0.15, 0.02, 0.0]
    assert added_ms(kernels[::-1]) == [0.0, 0.02, 0.15, 0.15, 0.1]   # in the order given
    assert added_ms([]) == []
