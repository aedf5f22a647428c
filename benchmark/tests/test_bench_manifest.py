"""BENCHMARK.json against the limits a benchmark manifest keeps, and against its own files."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / 'benchmark'
MANIFEST = json.loads((ROOT / 'BENCHMARK.json').read_text())
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
METRIC_KEYS = {'name', 'unit', 'better', 'source'}


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_top_level_keys():
    assert set(MANIFEST) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                             'end_to_end', 'per_layer'}
    assert MANIFEST['paths'] == ['benchmark']
    assert 1 <= MANIFEST['run_seconds'] <= 51 and isinstance(MANIFEST['run_seconds'], int)
    assert all(_one_line(w) for w in MANIFEST['command']) and len(MANIFEST['command']) <= 32
    assert not any(w.startswith('/') or '..' in w for w in MANIFEST['command'])


def test_check_budget_fits_the_full_benchmark():
    """A check of 24 cells: 2 + 14 x 24 runs of run_seconds + 60, 2 x 90 s a
    cell to compile, 1200 s spare, within 43200 s."""
    cells = 24
    total = (2 + 14 * cells) * (MANIFEST['run_seconds'] + 60) + cells * 180 + 1200
    assert total <= 43200


@pytest.mark.parametrize('entry', MANIFEST['configs'] + MANIFEST['workloads']
                         + MANIFEST['end_to_end'] + MANIFEST['per_layer'],
                         ids=lambda e: e['name'])
def test_names(entry):
    assert NAME.match(entry['name'])
    for key in ('config', 'traffic'):
        if key in entry:
            assert NAME.match(entry[key])
    if 'unit' in entry:
        assert UNIT.match(entry['unit'])
        assert entry['better'] in ('lower', 'higher')
    for key in ('why', 'layer', 'source'):
        if key in entry:
            assert _one_line(entry[key])


def test_names_unique():
    for group in ('configs', 'workloads'):
        names = [e['name'] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m['name'] for m in MANIFEST['end_to_end'] + MANIFEST['per_layer']]
    assert len(metrics) == len(set(metrics))


def test_configs():
    used = {w['config'] for w in MANIFEST['workloads']}
    for c in MANIFEST['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['name'] in used
        assert c['file'].startswith('benchmark/') and (ROOT / c['file']).is_file()
        cfg = json.loads((ROOT / c['file']).read_text())
        assert all(k in cfg for k in c['reduced'])
        assert not any(k.endswith(('_dim', '_rank', '_model')) for k in c['reduced'])


def test_workloads():
    configs = {c['name'] for c in MANIFEST['configs']}
    pairs = set()
    for w in MANIFEST['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['config'] in configs and w['chips'] == 1
        assert (BENCH / 'traffic' / f"{w['traffic']}.json").is_file()
        traffic = json.loads((BENCH / 'traffic' / f"{w['traffic']}.json").read_text())
        assert (BENCH / 'drivers' / f"{traffic['driver']}.py").is_file()
        spec = json.loads((BENCH / 'workloads' / f"{w['name']}.json").read_text())
        assert spec['trace_units'] >= 1 and spec['limits']
        pairs.add((w['config'], w['traffic']))
    assert len(pairs) == len(MANIFEST['workloads'])


def test_end_to_end():
    cells = {w['name'] for w in MANIFEST['workloads']}
    names = {m['name'] for m in MANIFEST['end_to_end']}
    assert 'setup_s' in names
    for m in MANIFEST['end_to_end']:
        assert set(m) - {'workloads'} == METRIC_KEYS | {'bound'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
        assert set(m.get('workloads', cells)) <= cells
    for cell in cells:
        reported = [m for m in MANIFEST['end_to_end'] if cell in m.get('workloads', cells)]
        assert len(reported) >= 2, cell       # setup_s and one more


def test_per_layer():
    cells = {w['name'] for w in MANIFEST['workloads']}
    e2e = {m['name']: m for m in MANIFEST['end_to_end']}
    layers = {}
    for m in MANIFEST['per_layer']:
        assert set(m) - {'workloads'} == METRIC_KEYS | {'layer', 'moves'}
        assert m['source'] in ('device_trace', 'program_span', 'program_counter', 'host_clock')
        assert (BENCH / 'metrics' / f"{m['name']}.py").is_file()
        assert m['moves'] in e2e
        for cell in m.get('workloads', cells):
            assert cell in cells
            assert cell in e2e[m['moves']].get('workloads', cells), (m['name'], cell)
        layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
    assert all(len(v) == 1 for v in layers.values())
    for cell in cells:
        assert any(cell in m.get('workloads', cells) for m in MANIFEST['per_layer'])


def test_file_size():
    assert len((ROOT / 'BENCHMARK.json').read_bytes()) <= 64 * 1024


def test_files_are_named_from_name_characters():
    for path in BENCH.rglob('*'):
        if '__pycache__' in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r'^[A-Za-z0-9_./-]+$', rel), rel
