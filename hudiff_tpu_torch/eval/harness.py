"""Evaluation harness CLI over humanization sample CSVs, in PyTorch.

Counterpart of hudiff_tpu/eval/harness.py (the reference's
antibody_scripts/patent_eval.py:232-323 / humab25_eval.py and
nanobody_scripts/nano_eval.py):

- sample rows are paired to their parental mouse / experimental humanized
  rows BY NAME (the sample CSV carries ``{name}human_sample``), so multiple
  samples per antibody and skipped antibodies never misalign the metrics;
- preservation (all / vernier) vs parental mouse, for both the samples and
  the experimental pairs;
- FR / vernier mutation precision vs experimental humanized pairs;
- consensus (pseudo-germline) and germline-graft FR identity;
- AbNatiV nativeness + improvement vs the parental mouse when scorer
  checkpoints are given: the f32 scorer on ``device`` (the card unless the
  caller passes ``device='cpu'``), AHo alignment through the native
  aligner's batch entry;
- OASis identity via the BioPhi subprocess when available;
- web-service metrics (T20) only with --web (they need egress; eval/web.py).

CSVs are read with ``csv``, not pandas: every cell keeps its text (a name
of digits such as ``007`` stays ``007``, an empty cell is ``''``), where
the JAX harness's pandas parses numbers.

Usage:
  python -m hudiff_tpu_torch.eval.harness ab --sample-csv sample.csv \\
      --pair-csv humanization_pair_data_filter.csv \\
      [--abnativ-vh vh.ckpt --abnativ-vlk vk.ckpt --abnativ-vll vl.ckpt]
  python -m hudiff_tpu_torch.eval.harness nano --sample-csv sample.csv \\
      [--abnativ-vh vh.ckpt --abnativ-vhh vhh.ckpt]
  (add --device cpu to score on the CPU)
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..utils.device import resolve_device
from . import metrics as M

SAMPLE_SUFFIX = 'human_sample'

Rows = List[Dict[str, str]]


def _read_csv(path: str) -> Tuple[List[str], Rows]:
    """(header, rows as dicts of the cells' text)."""
    with open(path, newline='') as f:
        reader = csv.DictReader(f)
        return list(reader.fieldnames or ()), list(reader)


def _mean(xs: List[float]) -> Optional[float]:
    return float(np.mean(xs)) if xs else None


def _column_mean(path: str, column: str) -> float:
    """Mean of a CSV column's non-empty cells (pandas' ``mean`` skips NaN)."""
    vals = [float(r[column]) for r in _read_csv(path)[1] if r[column] != '']
    return float(np.mean(vals)) if vals else float('nan')


def _parental_key(sample_name: str) -> str:
    """'{name}human_sample' -> '{name}' (humanize CLI row naming)."""
    if sample_name.endswith(SAMPLE_SUFFIX):
        return sample_name[: -len(SAMPLE_SUFFIX)]
    return sample_name


def _pairs_by_name(rows: Rows, h_col: str = 'h_seq', l_col: str = 'l_seq'
                   ) -> Dict[str, Tuple[str, str]]:
    return {str(r['name']): (r[h_col], r[l_col]) for r in rows}


def _exp_by_mouse_name(mouse: Rows, exp: Rows, columns: List[str]
                       ) -> Tuple[Dict[str, Tuple[str, str]], str]:
    """Map parental mouse name -> experimental humanized pair; ``columns`` is
    the pair CSV's header.

    The HuAb348 CSV links the groups by ``order_name`` ('0_mouse' /
    '0_humanized'); without it, groups that carry the same unique names pair
    by name; else positionally (the reference pairs purely by position,
    patent_eval.py:288-291) — but loudly, since positional pairing
    misaligns every metric as soon as one row is skipped. Returns
    ``(mapping, pairing_mode)``."""
    out: Dict[str, Tuple[str, str]] = {}
    if 'order_name' in columns:
        exp_by_order = {str(r['order_name']).split('_')[0]: (r['h_seq'], r['l_seq'])
                        for r in exp}
        for r in mouse:
            order = str(r['order_name']).split('_')[0]
            if order in exp_by_order:
                out[str(r['name'])] = exp_by_order[order]
        return out, 'order_name'
    mouse_names = [str(r['name']) for r in mouse]
    exp_names = [str(r['name']) for r in exp]
    shared = set(mouse_names) & set(exp_names)
    if (shared and len(set(mouse_names)) == len(mouse_names)
            and len(set(exp_names)) == len(exp_names)):
        exp_by = _pairs_by_name(exp)
        for name in mouse_names:
            if name in exp_by:
                out[name] = exp_by[name]
        return out, 'name'
    warnings.warn(
        'pair CSV has no order_name column: falling back to POSITIONAL '
        'experimental pairing (row i of the mouse group <-> row i of the '
        'humanized group). Any skipped row misaligns the precision metrics; '
        'prefer an order_name column or --experimental-csv.', stacklevel=2)
    for m, e in zip(mouse, exp):
        out[str(m['name'])] = (e['h_seq'], e['l_seq'])
    return out, 'positional'


def _grid_pair(h_seq: str, l_seq: str) -> Optional[Tuple[M.GridChain, M.GridChain]]:
    try:
        return M.GridChain(h_seq, True, 'H'), M.GridChain(l_seq, False)
    except ValueError:
        return None


def eval_ab(sample_csv: str, pair_csv: str, out_path: Optional[str] = None,
            abnativ_vh: Optional[str] = None,
            abnativ_vlk: Optional[str] = None,
            abnativ_vll: Optional[str] = None,
            oasis_db: Optional[str] = None,
            biophi_exec: str = 'biophi',
            parental_oasis: Optional[str] = None,
            experimental_oasis: Optional[str] = None,
            web: bool = False,
            mouse_t20_csv: Optional[str] = None,
            plots_dir: Optional[str] = None,
            experimental_csv: Optional[str] = None,
            device='cuda') -> Dict[str, object]:
    """Score an antibody humanization run against the paired eval set
    (mouse + experimental humanized, e.g. HuAb348 / Humab25 CSVs); the
    AbNatiV scorers run on ``device``."""
    _, sample = _read_csv(sample_csv)
    human = [r for r in sample if r['Specific'] == 'humanization']
    ref_columns, ref = _read_csv(pair_csv)
    typed = 'type' in ref_columns
    mouse = [r for r in ref if r['type'] == 'mouse'] if typed else ref
    exp = [r for r in ref if r['type'] == 'humanized'] if typed else []

    mouse_by_name = _pairs_by_name(mouse)
    if experimental_csv:
        # Humab25-style layout: experimental humanized pairs in their own CSV
        # (name/Raw_name + h_seq/l_seq), keyed to the mouse set by name
        # (reference humab25_eval.py:293-300)
        exp_columns, exp_rows = _read_csv(experimental_csv)
        name_col = 'name' if 'name' in exp_columns else 'Raw_name'
        exp_by_name = {str(r[name_col]): (r['h_seq'], r['l_seq']) for r in exp_rows}
        pairing_mode = 'experimental_csv'
    else:
        exp_by_name, pairing_mode = _exp_by_mouse_name(mouse, exp, ref_columns)

    report: Dict[str, object] = {'n_samples': len(human), 'pairing': pairing_mode}
    matched = 0
    skipped_unmatched = 0
    skipped_unaligned = 0
    pres = {'h_all': [], 'l_all': [], 'h_vernier': [], 'l_vernier': []}
    fr_prec = {'h': [], 'l': []}
    vr_prec = {'h': [], 'l': []}
    cons_h: List[float] = []
    cons_l: List[float] = []
    germ_h: List[float] = []
    germ_l: List[float] = []
    triples: List[Tuple[str, Tuple[str, str], Tuple[str, str]]] = []

    for row in human:
        key = _parental_key(str(row['name']))
        if key not in mouse_by_name:
            skipped_unmatched += 1
            continue
        m_h, m_l = mouse_by_name[key]
        s_h, s_l = row['hseq'], row['lseq']
        sample_grids = _grid_pair(s_h, s_l)
        mouse_grids = _grid_pair(m_h, m_l)
        if sample_grids is None or mouse_grids is None:
            skipped_unaligned += 1
            continue
        matched += 1
        triples.append((key, (s_h, s_l), (m_h, m_l)))
        pres['h_all'].append(M.all_preservation(sample_grids[0], mouse_grids[0]))
        pres['l_all'].append(M.all_preservation(sample_grids[1], mouse_grids[1]))
        pres['h_vernier'].append(M.vernier_preservation(sample_grids[0], mouse_grids[0]))
        pres['l_vernier'].append(M.vernier_preservation(sample_grids[1], mouse_grids[1]))
        cons_h.append(M.consensus_identity(sample_grids[0]))
        cons_l.append(M.consensus_identity(sample_grids[1]))
        germ_h.append(M.germline_identity(sample_grids[0]))
        germ_l.append(M.germline_identity(sample_grids[1]))
        if key in exp_by_name:
            exp_grids = _grid_pair(*exp_by_name[key])
            if exp_grids is not None:
                for chain in (0, 1):
                    tag = 'hl'[chain]
                    fr = M.mutation_precision(exp_grids[chain], mouse_grids[chain],
                                              sample_grids[chain])
                    vr = M.mutation_precision(exp_grids[chain], mouse_grids[chain],
                                              sample_grids[chain], vernier_only=True)
                    if fr is not None:
                        fr_prec[tag].append(fr)
                    if vr is not None:
                        vr_prec[tag].append(vr)

    report.update({
        'n_matched': matched,
        'n_skipped_unmatched': skipped_unmatched,
        'n_skipped_unaligned': skipped_unaligned,
        'preservation_all_h': _mean(pres['h_all']),
        'preservation_all_l': _mean(pres['l_all']),
        'preservation_vernier_h': _mean(pres['h_vernier']),
        'preservation_vernier_l': _mean(pres['l_vernier']),
        'fr_mutation_precision_h': _mean(fr_prec['h']),
        'fr_mutation_precision_l': _mean(fr_prec['l']),
        'vernier_mutation_precision_h': _mean(vr_prec['h']),
        'vernier_mutation_precision_l': _mean(vr_prec['l']),
        'consensus_fr_identity_h': _mean(cons_h),
        'consensus_fr_identity_l': _mean(cons_l),
        'germline_fr_identity_h': _mean(germ_h),
        'germline_fr_identity_l': _mean(germ_l),
    })

    # experimental-vs-mouse context aggregates (patent_eval.py:293-298)
    exp_pres_h, exp_pres_l = [], []
    for name, epair in exp_by_name.items():
        if name not in mouse_by_name:
            continue
        eg = _grid_pair(*epair)
        mg = _grid_pair(*mouse_by_name[name])
        if eg is None or mg is None:
            continue
        exp_pres_h.append(M.all_preservation(eg[0], mg[0]))
        exp_pres_l.append(M.all_preservation(eg[1], mg[1]))
    report['exp_preservation_all_h'] = _mean(exp_pres_h)
    report['exp_preservation_all_l'] = _mean(exp_pres_l)

    # AbNatiV improvement vs the parental mouse: one scorer call per chain
    # group over every sample and its parent
    if abnativ_vh and triples:
        n = len(triples)
        scores = abnativ_scores_local([t[1][0] for t in triples] + [t[2][0] for t in triples],
                                      'VH', abnativ_vh, device=device)
        s_scores, m_scores = scores[:n], scores[n:]
        report['abnativ_vh_mean'] = float(np.nanmean(s_scores))
        report['abnativ_vh_improvement'] = float(
            np.nanmean(s_scores) - np.nanmean(m_scores))
    if (abnativ_vlk or abnativ_vll) and triples:
        from ..numbering import align as AL
        by_group: Dict[str, List[Tuple[int, str, str]]] = {'K': [], 'L': []}
        for i, (_, (s_h, s_l), (m_h, m_l)) in enumerate(triples):
            try:
                group, margin = AL.classify_light(s_l)
            except ValueError:
                continue
            AL.warn_ambiguous_light(group, margin, context='selects the AbNatiV scorer')
            by_group['K' if group == 'K' else 'L'].append((i, s_l, m_l))
        sample_mother: Dict[int, Tuple[float, float]] = {}
        for group, ckpt, mtype in (('K', abnativ_vlk, 'VKappa'), ('L', abnativ_vll, 'VLambda')):
            rows = by_group[group]
            if not ckpt or not rows:
                continue
            scores = abnativ_scores_local([r[1] for r in rows] + [r[2] for r in rows],
                                          mtype, ckpt, device=device)
            for k, (i, _, _) in enumerate(rows):
                sample_mother[i] = (scores[k], scores[len(rows) + k])
        means, imp = [], []
        for i in sorted(sample_mother):   # the triples' order
            sv, mv = sample_mother[i]
            if np.isfinite(sv):
                means.append(sv)
            if np.isfinite(sv) and np.isfinite(mv):
                imp.append(sv - mv)
        report['abnativ_vl_mean'] = _mean(means)
        report['abnativ_vl_improvement'] = _mean(imp)

    # OASis identity (BioPhi subprocess; optional external tool)
    if oasis_db:
        from . import biophi as BP
        base = os.path.dirname(os.path.abspath(sample_csv))
        fasta = os.path.join(base, 'sample_identity.fa')
        if not os.path.exists(fasta):
            BP.sample_csv_to_fasta(sample_csv, fasta)
        xlsx = BP.run_oasis(fasta, oasis_db, os.path.join(base, 'sample_identity_oasis.xlsx'),
                            exec_path=biophi_exec)
        if xlsx:
            report['oasis_median_identity'] = BP.oasis_curve_mean(xlsx)
            if parental_oasis and os.path.exists(parental_oasis):
                mouse_mean = BP.oasis_curve_mean(parental_oasis)
                report['oasis_median_improvement'] = (
                    report['oasis_median_identity'] - mouse_mean)
                if experimental_oasis and os.path.exists(experimental_oasis):
                    report['exp_oasis_median_improvement'] = (
                        BP.oasis_curve_mean(experimental_oasis) - mouse_mean)
        else:
            report['oasis_median_identity'] = None  # biophi unavailable

    # T20 web battery (egress required; fail soft)
    if web:
        from . import web as W
        try:
            t20_path = W.t20_csv(sample_csv)
            report['t20_h_mean'] = _column_mean(t20_path, 'h_score')
            report['t20_l_mean'] = _column_mean(t20_path, 'l_score')
            if mouse_t20_csv and os.path.exists(mouse_t20_csv):
                report['t20_h_improvement'] = (
                    report['t20_h_mean'] - _column_mean(mouse_t20_csv, 'h_score'))
                report['t20_l_improvement'] = (
                    report['t20_l_mean'] - _column_mean(mouse_t20_csv, 'l_score'))
        except W.WebEvalUnavailable as e:
            report['t20_error'] = str(e)

    if plots_dir:
        _write_ab_plots(plots_dir, triples, exp_by_name, pres, report)

    if out_path:
        with open(out_path, 'w') as f:
            json.dump(report, f, indent=2)
    return report


def _write_ab_plots(plots_dir: str, triples, exp_by_name, pres,
                    report: Dict[str, object]) -> None:
    """Figure battery for an antibody eval run: preservation distributions,
    mutation-overlap venns vs the experimental humanization, and a
    position-level conservation table."""
    from . import plots as P
    os.makedirs(plots_dir, exist_ok=True)
    P.score_distributions(
        {'H all': pres['h_all'], 'L all': pres['l_all'],
         'H vernier': pres['h_vernier'], 'L vernier': pres['l_vernier']},
        os.path.join(plots_dir, 'preservation_dist.png'),
        xlabel='preservation vs parental')

    with_exp = [(name, spair, mpair, exp_by_name[name])
                for name, spair, mpair in triples if name in exp_by_name]
    if with_exp:
        rows = P.overlap_table([t[2] for t in with_exp], [t[3] for t in with_exp],
                               [t[1] for t in with_exp], names=[t[0] for t in with_exp])
        if rows:
            P.plot_overlap(rows, os.path.join(plots_dir, 'overlap_mean.png'))
            P.plot_overlap_venns(rows, os.path.join(plots_dir, 'overlap_venns.png'))
            report['overlap_shared_mean'] = float(np.mean([r['Shared'] for r in rows]))

    # position-level conservation vs the parental germline graft
    # (utils/evaluation.py collect_positions)
    rows = []
    for name, (s_h, s_l), (m_h, m_l) in triples:
        try:
            rows += M.collect_positions(M.GridChain(m_h, True, 'H'),
                                        M.GridChain(s_h, True, 'H'), name)
            rows += M.collect_positions(M.GridChain(m_l, False), M.GridChain(s_l, False), name)
        except ValueError:
            continue
    if rows:
        path = os.path.join(plots_dir, 'conservation_positions.csv')
        with open(path, 'w', newline='') as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)


# loaded scorers by (checkpoint, device)
_ABNATIV_CACHE: Dict[Tuple[str, str], torch.nn.Module] = {}


def _score_batch(model, x: torch.Tensor, model_type: str) -> torch.Tensor:
    """Whole-sequence nativeness of one batch of AHo one-hots."""
    from ..models import abnativ as AB
    return AB.nativeness_scores_seq(model(x), model_type)


def abnativ_scores_local(seqs: List[str], model_type: str, ckpt: str,
                         batch_size: int = 64, device='cuda') -> List[float]:
    """Whole-sequence AbNatiV nativeness (VH / VKappa / VLambda / VHH) by the
    f32 scorer on ``device`` (replaces the `abnativ score` subprocess,
    nano_eval.py:92-108); NaN for a sequence that does not align.

    The scorer is loaded once per (ckpt, device) at the file's hparams; the
    sequences are aligned in one ``align_to_aho_batch`` call (ANARCI per
    sequence when it is installed) and scored in batches of ``batch_size``,
    the last padded with copies of its first row, so that every call has one
    shape and a sequence's score does not depend on its batch.
    """
    from ..numbering import aho as AHO
    from ..numbering import align as AL
    from ..tokenizer import aho_onehot
    from ..training.finetune import load_abnativ

    dev = resolve_device(device)
    key = (ckpt, str(dev))
    if key not in _ABNATIV_CACHE:
        _ABNATIV_CACHE[key] = load_abnativ(ckpt, straight_through=False, device=dev)
    model = _ABNATIV_CACHE[key]

    profile = {'VH': 'H', 'VHH': 'VHH', 'VKappa': 'K', 'VLambda': 'L'}[model_type]
    try:
        import anarci  # type: ignore  # noqa: F401
        has_anarci = True
    except ImportError:
        has_anarci = False
    if has_anarci:  # pragma: no cover - external binary
        aligned = [AHO.align_aho(s, is_VHH=(model_type == 'VHH')) for s in seqs]
    else:
        aligned = [r[0] if r is not None else None
                   for r in AL.align_to_aho_batch(seqs, profile)]

    valid = [(i, a) for i, a in enumerate(aligned) if a is not None]
    scores = [float('nan')] * len(seqs)
    with torch.inference_mode():
        for s0 in range(0, len(valid), batch_size):
            chunk = valid[s0:s0 + batch_size]
            x = np.stack([aho_onehot(a) for _, a in chunk])
            n = x.shape[0]
            if n < batch_size:
                x = np.concatenate([x, np.repeat(x[:1], batch_size - n, axis=0)], axis=0)
            sc = _score_batch(model, torch.from_numpy(x).to(dev), model_type)[:n].cpu()
            for (i, _), v in zip(chunk, sc.tolist()):
                scores[i] = float(v)
    return scores


def eval_nano(sample_csv: str, abnativ_vh: Optional[str] = None,
              abnativ_vhh: Optional[str] = None,
              out_path: Optional[str] = None,
              web: bool = False, device='cuda') -> Dict[str, object]:
    """Nanobody metrics (nano_eval.py:81-142): AbNatiV VH/VHH improvement vs
    the published parental means, consensus FR identity, preservation.
    Sample rows pair to parentals by name; the scorers run on ``device``."""
    columns, sample = _read_csv(sample_csv)
    human = [r for r in sample if r['Specific'] == 'humanization']
    parental = [r for r in sample if r['Specific'] == 'camel']
    col = 'vhh_seq' if 'vhh_seq' in columns else columns[2]
    parental_by_name = {str(r['name']): r[col] for r in parental}

    seqs = [r[col] for r in human]
    report: Dict[str, object] = {'n_samples': len(seqs)}

    pres = []
    matched = 0
    for row in human:
        par = parental_by_name.get(_parental_key(str(row['name'])))
        if par is None:
            continue
        try:
            a = M.GridChain(row[col], True, 'VHH')
            b = M.GridChain(par, True, 'VHH')
        except ValueError:
            continue
        matched += 1
        pres.append(M.all_preservation(a, b))
    report['n_matched'] = matched
    report['preservation_all'] = _mean(pres)

    cons = []
    germ = []
    for s in seqs:
        try:
            cons.append(M.consensus_identity(M.GridChain(s, True, 'H')))
            germ.append(M.germline_identity(M.GridChain(s, True, 'H')))
        except ValueError:
            continue
    report['consensus_fr_identity'] = _mean(cons)
    report['germline_fr_identity'] = _mean(germ)

    if abnativ_vh:
        vh = abnativ_scores_local(seqs, 'VH', abnativ_vh, device=device)
        report['abnativ_vh_mean'] = float(np.nanmean(vh))
        report['abnativ_vh_improvement'] = (
            report['abnativ_vh_mean'] - C.NANO_EVAL_REF_VH_SCORE)
    if abnativ_vhh:
        vhh = abnativ_scores_local(seqs, 'VHH', abnativ_vhh, device=device)
        report['abnativ_vhh_mean'] = float(np.nanmean(vhh))
        report['abnativ_vhh_delta'] = (
            report['abnativ_vhh_mean'] - C.NANO_EVAL_REF_VHH_SCORE)

    if web:
        from . import web as W
        try:
            report['t20_frame_mean'] = _column_mean(W.t20_frame_csv(sample_csv), 'h_score')
        except W.WebEvalUnavailable as e:
            report['t20_error'] = str(e)

    if out_path:
        with open(out_path, 'w') as f:
            json.dump(report, f, indent=2)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest='cmd', required=True)
    a = sub.add_parser('ab')
    a.add_argument('--sample-csv', required=True)
    a.add_argument('--pair-csv', required=True)
    a.add_argument('--out', default=None)
    a.add_argument('--abnativ-vh', default=None)
    a.add_argument('--abnativ-vlk', default=None)
    a.add_argument('--abnativ-vll', default=None)
    a.add_argument('--oasis-db', default=None,
                   help='OASis 9-mer DB path; runs the biophi subprocess '
                        'when the executable exists')
    a.add_argument('--biophi-exec', default='biophi')
    a.add_argument('--parental-oasis', default=None,
                   help='precomputed parental OASis xlsx (improvement base)')
    a.add_argument('--experimental-oasis', default=None)
    a.add_argument('--experimental-csv', default=None,
                   help='separate experimental-humanized CSV (Humab25 '
                        'layout: name/Raw_name + h_seq/l_seq), keyed to the '
                        'mouse set by name')
    a.add_argument('--mouse-t20-csv', default=None,
                   help='precomputed mouse T20 CSV (improvement base)')
    a.add_argument('--web', action='store_true',
                   help='also run T20 web evaluations (needs egress)')
    a.add_argument('--plots', default=None, metavar='DIR',
                   help='write the figure battery (preservation dists, '
                        'mutation-overlap venns, conservation-position CSV) '
                        'into DIR')
    n = sub.add_parser('nano')
    n.add_argument('--sample-csv', required=True)
    n.add_argument('--abnativ-vh', default=None)
    n.add_argument('--abnativ-vhh', default=None)
    n.add_argument('--web', action='store_true')
    n.add_argument('--out', default=None)
    for q in (a, n):
        q.add_argument('--device', default='cuda',
                       help="torch device of the AbNatiV scorers; 'cpu' to score on the CPU")
    args = p.parse_args(argv)
    if args.cmd == 'ab':
        report = eval_ab(args.sample_csv, args.pair_csv, args.out,
                         abnativ_vh=args.abnativ_vh,
                         abnativ_vlk=args.abnativ_vlk,
                         abnativ_vll=args.abnativ_vll,
                         oasis_db=args.oasis_db,
                         biophi_exec=args.biophi_exec,
                         parental_oasis=args.parental_oasis,
                         experimental_oasis=args.experimental_oasis,
                         web=args.web,
                         mouse_t20_csv=args.mouse_t20_csv,
                         plots_dir=args.plots,
                         experimental_csv=args.experimental_csv,
                         device=args.device)
    else:
        report = eval_nano(args.sample_csv, args.abnativ_vh, args.abnativ_vhh,
                           args.out, web=args.web, device=args.device)
    print(json.dumps(report, indent=2))
    return report


if __name__ == '__main__':
    main()
