"""Cells at a size the CPU tests can hold: every width narrowed, one
attention head of 64, few rows; the port's plain paths on the CPU, in
float32, so that a sound run reads next to 0 against the cells' limits
(set from bf16 runs at full size on the card)."""
import json

from benchmark import harness as H

NARROW = dict(d_embedding=64, d_model=64, n_encoder_layers=1, s_model=64, r_model=64,
              n_pos_model=64, dual_layers=2, att_model=64, nhead=1, dim_feedforward=64,
              cs_layers=1)
TRAFFIC = {'humanize_packed': {'pool': 4, 'antibodies_per_round': 2, 'rows_per_antibody': 2,
                               'pack_size': 4},
           'humanize_single': {'pool': 4, 'rows': 4},
           'pretrain': {'pool': 2},
           'finetune_nano': {'pool': 2}}
CELLS = [w['name'] for w in H.load_json(H.ROOT / 'BENCHMARK.json')['workloads']]
# a cell whose files stay under benchmark/ with no entry in BENCHMARK.json
# (PERF.md, Open questions): the tests still drive its code
UNLISTED = {'ab_pretrain_b128': {'name': 'ab_pretrain_b128', 'config': 'hudiff_ab',
                                 'traffic': 'ab_pretrain_pool', 'chips': 1}}


def tiny_cell(name: str, **traffic) -> H.Cell:
    manifest = H.load_json(H.ROOT / 'BENCHMARK.json')
    manifest['workloads'] += [UNLISTED[name]] if name in UNLISTED else []
    cell = H.Cell.load(name, manifest)
    cell.cfg.update(NARROW, sum_d_model=192 if cell.cfg['kind'] == 'pair' else 128,
                    dtype='float32')
    for section in ('train', 'finetune'):
        if section in cell.cfg:
            cell.cfg[section] = dict(cell.cfg[section], batch_size=4)
    cell.traffic.update(TRAFFIC[cell.traffic['driver']])
    cell.traffic.update(traffic)
    cell.spec = dict(cell.spec, trace_units=2)
    return cell


def run(cell: H.Cell, trace: bool = False, driver_cls=None, seed: int = 2 ** 33 + 5) -> dict:
    result = H.run_cell(cell, seed, 0.5, trace, 'cpu', driver_cls=driver_cls)
    json.dumps(result)
    return result
