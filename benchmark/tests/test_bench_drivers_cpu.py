"""One tiny run of each cell's driver on the CPU, through the port's plain
paths: a well-formed result whose device metrics are absent (not measured
without a card), and a correct check."""
import subprocess
import sys
from pathlib import Path

import pytest

from bench_tiny import CELLS, run, tiny_cell


@pytest.mark.parametrize('trace', [False, True], ids=['window', 'traced'])
@pytest.mark.parametrize('name', CELLS)
def test_tiny_run(name, trace):
    cell = tiny_cell(name)
    r = run(cell, trace)
    assert list(r) == ['correct', 'attempted', 'failed', 'metrics', 'device', 'check']
    assert r['correct'] is True and r['attempted'] >= 1 and r['failed'] == 0
    assert r['device']['platform'] == 'cpu'
    assert all(c['value'] <= c['limit'] for c in r['check'].values())
    got = set(r['metrics'])
    if not trace:
        assert got == {m['name'] for m in cell.end_to_end}
        assert all(v['value'] > 0 for v in r['metrics'].values())
    else:
        device = {m['name'] for m in cell.per_layer if m['source'] == 'device_trace'}
        host = {m['name'] for m in cell.per_layer} - device
        assert got == host      # device metrics: not measured on the CPU


def test_control_reads():
    cell = tiny_cell(CELLS[0])
    from benchmark import harness as H
    drv = H.load_module(H.BENCH_DIR / 'drivers' / f"{cell.traffic['driver']}.py", 'd').Driver

    class WithControl(drv):
        def check(self, control=False):
            return super().check(control=True)
    check = run(cell, driver_cls=WithControl)['check']
    assert check['control_gap_max']['value'] > check['gap_max']['value']


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', CELLS[0],
                          '--seed', '1', '--seconds', '1', '--trace', '0'],
                         cwd=str(Path(__file__).resolve().parents[2]),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ''
