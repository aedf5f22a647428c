"""The port's bench (``python -m hudiff_tpu_torch.bench``) on the CPU at
``HUDIFF_BENCH_TINY`` size: it prints exactly one JSON line with
bench.py's keys, and a section that fails puts ``error`` in that line and
exits 1. Importing the module runs nothing. Numbers from the CPU are not
held: only the line's form, the tp smoke's exact equality and the
sections' presence."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {'HUDIFF_BENCH_TINY': '1', 'HUDIFF_BENCH_B': '2', 'HUDIFF_BENCH_NANO_B': '2',
        'HUDIFF_BENCH_TRAIN_B': '4', 'HUDIFF_BENCH_FT_B': '4'}
SECTIONS = ('nano_sampling', 'tp_shard_map_smoke', 'pretrain_step', 'nano_finetune_step')


def _bench(**env):
    full = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS='1', **TINY)
    full.update(env)
    return subprocess.run([sys.executable, '-m', 'hudiff_tpu_torch.bench', '--device', 'cpu'],
                          cwd=REPO, env=full, capture_output=True, text=True, timeout=600)


def test_bench_prints_one_json_line_with_bench_py_keys():
    proc = _bench()
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert set(line) == {'metric', 'value', 'unit', 'vs_baseline', 'detail'}
    assert line['metric'] == 'ab_humanization_throughput'
    assert line['unit'] == 'seqs/sec/chip'
    assert line['value'] > 0 and line['vs_baseline'] > 0
    d = line['detail']
    for key in ('batch', 'positions', 'scan_sec_per_batch', 'eager_sec_per_batch',
                'sequential_sec_per_seq', 'sequential_sec_per_seq_runs', 'device_kind',
                'power_limit', 'launches', *SECTIONS):
        assert key in d, key
    assert d['batch'] == 2 and d['positions'] == 185 and d['device_kind'] == 'cpu'
    assert len(d['sequential_sec_per_seq_runs']) == 3
    assert d['nano_sampling']['positions'] == 93
    assert d['tp_shard_map_smoke']['max_abs_err_vs_unsharded'] == 0.0
    assert 'fed' in d['pretrain_step'] and d['pretrain_step']['fed']['n_steps'] == 50
    assert d['pretrain_step']['batch'] == 4 and d['nano_finetune_step']['batch'] == 4
    assert 'mfu_pct' not in d['pretrain_step']   # no device metric from a CPU run
    assert not any('error' in d[s] for s in SECTIONS)


def test_a_failed_section_puts_error_in_the_line_and_exits_1(monkeypatch, capsys):
    """The headline stands, the nano section raises: the line keeps the
    headline's numbers, names the section in ``error`` and the run exits 1
    without running the sections after it."""
    from hudiff_tpu_torch import bench

    def headline(dev, result):
        result['value'] = 5.0
        result['detail']['batch'] = 2

    def broken(dev):
        raise RuntimeError('no nanobodies today')

    def never(dev):
        raise AssertionError('a section after the failed one ran')

    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, 'ab_sampling', headline)
    monkeypatch.setattr(bench, 'nano_sampling', broken)
    monkeypatch.setattr(bench, 'tp_smoke', never)
    assert bench.main(['--device', 'cpu']) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line['error'] == 'nano_sampling: RuntimeError: no nanobodies today'
    assert line['value'] == 5.0 and line['detail']['batch'] == 2
    assert 'tp_shard_map_smoke' not in line['detail']


@pytest.mark.parametrize('knob,value', [('HUDIFF_BENCH_B', '0'), ('HUDIFF_BENCH_NANO_B', '-2')])
def test_a_bad_batch_knob_fails_its_section(monkeypatch, capsys, knob, value):
    from hudiff_tpu_torch import bench
    for k, v in {**TINY, knob: value}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(bench, 'ab_sampling', lambda dev, result: None)
    assert bench.main(['--device', 'cpu']) == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert knob in line['error']


def test_importing_the_bench_runs_nothing():
    code = ('import sys, hudiff_tpu_torch.bench as b; '
            'print(sys.modules.get("hudiff_tpu_torch.bench") is b)')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                          text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'True' and proc.stderr == ''
