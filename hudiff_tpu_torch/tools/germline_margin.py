"""Germline-breadth sensitivity study, on the port's germline library.

Counterpart of tools/germline_margin.py (host only: no model, no card), on
``hudiff_tpu_torch.numbering.germline``. It measures, on every chain of a
pair CSV (HuAb348: 348 mouse + 348 experimentally humanized pairs, H and
L), what the library's breadth costs and what the round-5 allele additions
bought:

1. the best-vs-second gene FR-identity margin in residues (gene-grouped:
   the max over each gene's alleles) over the occupied FR1-FR3 slots, and
   the fractions of chains with a margin above 2 and 4 residues;
2. before/after the additions (IGHV3-23*04, IGKV3D-20*01, IGKV2D-29*01,
   IGLV2-14*03): each chain's identity gain, winner-gene flips and the
   margins against the one-allele-per-gene library;
3. the share of chains whose winning gene carries two or more alleles, and
   the identity bound for the rest (2 residues over the mean FR slots).

Output: one JSON object, the JAX tool's. ``HUAB348`` is the CSV it reads
(columns ``h_seq`` and ``l_seq``; read with ``csv``, no pandas). It has no
default; set it, then call ``main``:

    python -c 'from hudiff_tpu_torch.tools import germline_margin as G;
               G.HUAB348 = "<pair csv>"; G.main()'
"""
from __future__ import annotations

import csv
import json
from typing import Optional

import numpy as np

from . import dataset_csv

# The upstream release's HuAb348 pair CSV
# (antibody_eval_data/HuAb348_data/humanization_pair_data_filter.csv). It is
# not in the repository, so it has no default: set it before running the tool.
HUAB348: Optional[str] = None

# alleles added in round 5 on top of the round-4 one-allele-per-gene
# library; excluding them reproduces the round-4 "before" measurement
ADDED_R5 = frozenset({'IGHV3-23*04', 'IGKV3D-20*01', 'IGKV2D-29*01',
                      'IGLV2-14*03'})


def _gene_scores(allele_scores, exclude=frozenset()):
    from ..numbering import germline as G
    return G.group_allele_scores(allele_scores, exclude=exclude)


def _top2(scores):
    ranked = sorted(scores.items(), key=lambda kv: -kv[1])
    return ranked[0], ranked[1]


def chain_rows(seqs, group):
    """Per-chain records: gene-grouped margins after (full library) and
    before (round-4 library), the winner flip, and the identity gain from
    the added alleles."""
    from ..numbering import germline as G
    from ..numbering import imgt as IMGT

    rows = []
    for seq in seqs:
        placed = IMGT.grid_string(seq, heavy=group == 'H', chain_hint=group)
        if placed is None:
            continue
        grid = np.asarray(list(placed['grid']))
        allele_scores = G.v_gene_scores(grid, group)
        after = _gene_scores(allele_scores)
        before = _gene_scores(allele_scores, exclude=ADDED_R5)
        if len(after) < 2:
            continue
        fr = ~G._cdr_mask(group == 'H')
        fr4 = np.zeros_like(fr)
        fr4[-G._FR4_LEN[group]:] = True
        n_fr = int(((grid != '-') & fr & ~fr4).sum())
        (w_a, s_a), (_, s2_a) = _top2(after)
        (w_b, s_b), (_, s2_b) = _top2(before)
        multi = len([a for a in allele_scores if G.gene_of(a) == w_a]) >= 2
        rows.append({
            'margin_res_after': (s_a - s2_a) * n_fr,
            'margin_res_before': (s_b - s2_b) * n_fr,
            'gain_pts': s_a - s_b,
            'flip': w_a != w_b,
            'winner_multiallele': multi,
            'n_fr': n_fr,
        })
    return rows


def summarize(rows):
    if not rows:
        return None
    m_after = np.asarray([r['margin_res_after'] for r in rows])
    m_before = np.asarray([r['margin_res_before'] for r in rows])
    gain = np.asarray([r['gain_pts'] for r in rows])
    return {
        'n_chains': len(rows),
        'margin_residues': {
            'median': round(float(np.median(m_after)), 2),
            'p10': round(float(np.percentile(m_after, 10)), 2),
            'min': round(float(m_after.min()), 2),
        },
        'frac_margin_gt_2res': round(float((m_after > 2).mean()), 4),
        'frac_margin_gt_4res': round(float((m_after > 4).mean()), 4),
        'mean_fr_slots': round(float(np.mean([r['n_fr'] for r in rows])), 1),
        'before_r5': {
            'frac_margin_gt_2res': round(float((m_before > 2).mean()), 4),
            'median_margin_res': round(float(np.median(m_before)), 2),
        },
        'r5_alleles': {
            'winner_flips': int(sum(r['flip'] for r in rows)),
            'frac_winner_multiallele': round(
                float(np.mean([r['winner_multiallele'] for r in rows])), 4),
            'identity_gain_pts': {
                'mean': round(float(gain.mean()), 5),
                'max': round(float(gain.max()), 5),
                'frac_gained': round(float((gain > 0).mean()), 4),
            },
        },
    }


def study(h_seqs, l_seqs) -> dict:
    """The JSON object over the heavy chains and the light chains (split
    into kappa and lambda by ``classify_light``)."""
    from ..numbering.align import classify_light
    out = {'H': summarize(chain_rows(h_seqs, 'H')),
           'K': summarize(chain_rows([s for s in l_seqs if classify_light(s)[0] == 'K'], 'K')),
           'L': summarize(chain_rows([s for s in l_seqs if classify_light(s)[0] == 'L'], 'L'))}
    # one representative allele can underreport germline FR identity by at
    # most d/|FR|, d the within-gene allele distance (<= 2 residues at the
    # IMGT allele scale); chains whose winner carries >= 2 alleles have the
    # gain measured above instead
    groups = [out[g] for g in ('H', 'K', 'L') if out.get(g)]
    mean_fr = np.mean([v['mean_fr_slots'] for v in groups])
    out['identity_bound_pts_at_2res'] = round(2.0 / mean_fr, 4)
    covered = [v['r5_alleles']['frac_winner_multiallele'] * v['n_chains'] for v in groups]
    total = sum(v['n_chains'] for v in groups)
    out['frac_chains_winner_multiallele'] = round(sum(covered) / total, 4)
    return out


def main():
    with open(dataset_csv(HUAB348, 'HUAB348'), newline='') as f:
        rows = list(csv.DictReader(f))
    out = study([r['h_seq'] for r in rows], [r['l_seq'] for r in rows])
    print(json.dumps(out, indent=2))
    return out


if __name__ == '__main__':
    main()
