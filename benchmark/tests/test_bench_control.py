"""On the card, at each cell's own size: the control (the float32 reference
put in the program's place and computed with fp8-rounded products) fails
one of the cell's numbers on three seeds, and the program passes them all.

    python -m pytest benchmark/tests/test_bench_control.py -m cuda
"""
import pytest

from bench_tiny import CELLS

from benchmark import calibrate
from benchmark import harness as H

UNITS = {'humanize_packed': 1, 'humanize_single': 20, 'pretrain': 3, 'finetune_nano': 3}
SEEDS = (2 ** 32 + 11, 2 ** 32 + 12, 2 ** 32 + 13)


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_control_fails_and_program_passes(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the cells run the port\'s CUDA kernels')
    cell = H.Cell.load(name)
    limits = cell.spec['limits']
    for seed in SEEDS:
        got = calibrate.readings(name, seed, UNITS[cell.traffic['driver']], control=True)
        readings = got['readings']
        assert all(readings[k] <= limits.get(k, 0.0) for k in readings
                   if not k.startswith(('control_', 'all_'))), readings
        assert any(readings[f'control_{k}'] > limits[k] for k in limits
                   if f'control_{k}' in readings), readings
