"""Regenerate the demo checkpoints' eval reports, live, through the port.

Counterpart of tools/regen_demo_eval.py. It runs the port's shipped
pipeline on the in-repo Orbax demos (read without JAX): the humanize CLI
(``python -m hudiff_tpu_torch.sampling.humanize ab|nano --ckpt
examples/demo_*_tiny``), then the eval harness (``python -m
hudiff_tpu_torch.eval.harness``), each in its own process.

  full    the whole dataset (``HUAB348`` / ``VHH_CSV``); ``--write`` writes
          the report to examples/demo_{ab,nb}_eval.json;
  subset  the first N antibodies (``--subset N``), no write.

``HUAB348`` and ``VHH_CSV`` have no default; set them, then call ``main``
with the command line's arguments:

    python -c 'from hudiff_tpu_torch.tools import regen_demo_eval as R;
               R.HUAB348 = "<pair csv>"; R.main()' ab [--subset N | --write]

Both modes hold every band of the JAX tool (``check_ab_bands`` /
``check_nano_bands`` give each band's reading, ``hold_bands`` raises on the
first that fails). CSVs are read and written with ``csv`` (no pandas). The
Python entry points ``regen_ab`` / ``regen_nano`` take ``device`` (the
CLIs' ``--device``; ``'cpu'`` also passes ``--fp32``) and return the
report with its ``bands``, the seconds of each stage (``stages_s``) and
the humanize CLI's sample rows (``samples``).
"""
from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from . import dataset_csv

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# The upstream release's HuAb348 pair CSV
# (antibody_eval_data/HuAb348_data/humanization_pair_data_filter.csv) and
# VHH CSV (nanobody_eval_data/abnativ_select_vhh.csv). They are not in the
# repository, so they have no default: set them before running the tool.
HUAB348: Optional[str] = None
VHH_CSV: Optional[str] = None


def _run(cmd, **kw):
    print('+', ' '.join(cmd), file=sys.stderr)
    res = subprocess.run(cmd, text=True, capture_output=True, **kw)
    if res.returncode != 0:
        raise RuntimeError(f'{cmd[2]} failed rc={res.returncode}:\n{res.stderr[-2000:]}')
    return res


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p]))


def _result_csv(logdir: str) -> str:
    """The humanize CLI writes <logdir>/<run>/sample_humanization_result.csv."""
    hits = glob.glob(os.path.join(logdir, '*', 'sample_humanization_result.csv'))
    assert hits, f'no result csv under {logdir}'
    return sorted(hits)[-1]


def _subset_csv(src: str, n: int, tmpdir: str) -> str:
    """The first n mouse pairs and the rows sharing their names (a pair CSV),
    or the first n rows (a VHH CSV), in the source's columns."""
    with open(src, newline='') as f:
        reader = csv.DictReader(f)
        cols, rows = reader.fieldnames, list(reader)
    if 'type' in cols:
        names = {r['name'] for r in [r for r in rows if r['type'] == 'mouse'][:n]}
        keep = [r for r in rows if r['name'] in names]
    else:
        keep = rows[:n]
    path = os.path.join(tmpdir, 'subset.csv')
    with open(path, 'w', newline='') as f:
        w = csv.DictWriter(f, fieldnames=cols)
        w.writeheader()
        w.writerows(keep)
    return path


def _device_args(device: str):
    return ['--device', device] + (['--fp32'] if device == 'cpu' else [])


def _regen(kind: str, subset: Optional[int], seed: int, device: str,
           stages: Dict[str, float]) -> Tuple[dict, List[dict]]:
    src = (dataset_csv(HUAB348, 'HUAB348') if kind == 'ab'
           else dataset_csv(VHH_CSV, 'VHH_CSV'))
    demo = os.path.join(REPO, 'examples', 'demo_ab_tiny' if kind == 'ab' else 'demo_nb_tiny')
    with tempfile.TemporaryDirectory(prefix=f'regen_{kind}_') as tmp:
        data = src if not subset else _subset_csv(src, subset, tmp)
        t0 = time.perf_counter()
        _run([sys.executable, '-m', 'hudiff_tpu_torch.sampling.humanize', kind,
              '--ckpt', demo, '--data-fpath', data, '--batch-size', '16',
              '--pack-size', '256', '--seed', str(seed),
              '--logdir', os.path.join(tmp, 'logs'), *_device_args(device)],
             cwd=REPO, env=_env())
        stages['humanize_s'] = time.perf_counter() - t0
        sample_csv = _result_csv(os.path.join(tmp, 'logs'))
        with open(sample_csv, newline='') as f:
            samples = [r for r in csv.DictReader(f) if r.get('Specific') == 'humanization']
        out_json = os.path.join(tmp, 'report.json')
        t0 = time.perf_counter()
        harness = [sys.executable, '-m', 'hudiff_tpu_torch.eval.harness', kind,
                   '--sample-csv', sample_csv, '--out', out_json, '--device', device]
        if kind == 'ab':
            harness[6:6] = ['--pair-csv', src]
        _run(harness, cwd=REPO, env=_env())
        stages['harness_s'] = time.perf_counter() - t0
        with open(out_json, encoding='UTF-8') as f:
            return json.load(f), samples


def check_ab_bands(r: dict, n_expected: int) -> Dict[str, bool]:
    """The JAX tool's bands, each True when it holds: a humanizing
    checkpoint moves germline FR identity above the mouse baseline (H 0.732
    / L 0.767) toward, but below, the experimentally humanized level (H
    0.895 / L 0.901)."""
    return {'n_matched': r['n_matched'] >= int(0.9 * n_expected),
            'germline_fr_identity_h': 0.76 < r['germline_fr_identity_h'] < 0.895,
            'germline_fr_identity_l': 0.79 < r['germline_fr_identity_l'] < 0.901,
            'preservation_all_h': r['preservation_all_h'] > 0.70,
            'preservation_all_l': r['preservation_all_l'] > 0.70,
            'n_skipped_unmatched': r.get('n_skipped_unmatched', 0) == 0}


def check_nano_bands(r: dict, n_expected: int) -> Dict[str, bool]:
    """The JAX tool's nano bands: demo_nb_tiny reconstructs the camelid VHHs
    it was trained on, so preservation is high and consensus / germline FR
    identity stay in a band around the parental level (0.8081 / 0.7936)."""
    return {'n_matched': r['n_matched'] >= int(0.9 * n_expected),
            'preservation_all': r['preservation_all'] > 0.85,
            'consensus_fr_identity': 0.75 < r['consensus_fr_identity'] < 0.92,
            'germline_fr_identity': 0.72 < r['germline_fr_identity'] < 0.92}


def hold_bands(kind: str, report: dict, bands: Dict[str, bool]) -> None:
    failed = [k for k, ok in bands.items() if not ok]
    if failed:
        raise AssertionError(f'{kind} report outside its bands {failed}: {report}')


def _write(report: dict, name: str) -> None:
    dest = os.path.join(REPO, 'examples', name)
    with open(dest, 'w', encoding='UTF-8') as f:
        json.dump(report, f, indent=2, sort_keys=True)
    print(f'wrote {dest}', file=sys.stderr)


def regen_ab(subset: Optional[int], write: bool, seed: int = 2023,
             device: str = 'cuda') -> dict:
    stages: Dict[str, float] = {}
    report, samples = _regen('ab', subset, seed, device, stages)
    bands = check_ab_bands(report, n_expected=subset or 340)
    hold_bands('ab', report, bands)
    if write:
        _write(report, 'demo_ab_eval.json')
    return {**report, 'bands': bands, 'stages_s': stages, 'samples': samples}


def regen_nano(subset: Optional[int], write: bool, seed: int = 2023,
               device: str = 'cuda') -> dict:
    stages: Dict[str, float] = {}
    report, samples = _regen('nano', subset, seed, device, stages)
    bands = check_nano_bands(report, n_expected=subset or 290)
    hold_bands('nano', report, bands)
    if write:
        _write(report, 'demo_nb_eval.json')
    return {**report, 'bands': bands, 'stages_s': stages, 'samples': samples}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('kind', choices=['ab', 'nano'])
    p.add_argument('--subset', type=int, default=None,
                   help='only the first N antibodies (fast live check)')
    p.add_argument('--write', action='store_true',
                   help='write the examples/ artifact (full runs only)')
    p.add_argument('--seed', type=int, default=2023)
    args = p.parse_args(argv)
    if args.write and args.subset:
        raise SystemExit('--write requires a full run (drop --subset)')
    fn = regen_ab if args.kind == 'ab' else regen_nano
    report = fn(args.subset, args.write, args.seed)
    print(json.dumps(report, indent=2, sort_keys=True))
    return report


if __name__ == '__main__':
    main()
