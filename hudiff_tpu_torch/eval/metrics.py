# Copied from hudiff_tpu/eval/metrics.py.
"""Humanization quality metrics.

Rebuilds the abnumber-based metrics of antibody_scripts/patent_eval.py:17-213
and humab25_eval.py on the framework's own IMGT grids: two sequences aligned
to the same fixed grid are compared slot-by-slot (abnumber's Chain.align
does the same through ANARCI positions).

Vernier-zone membership uses the reference's Kabat-vernier tables
(constants.HEAVY/LIGHT_CDR_KABAT_VERNIER value 5); CDR membership uses the
Kabat CDR marks (values 1-3).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import constants as C
from ..numbering import align as AL
from ..numbering import imgt as IMGT


class GridChain:
    """A chain placed on its fixed IMGT grid (abnumber.Chain equivalent)."""

    def __init__(self, seq: str, heavy: bool, chain_hint: Optional[str] = None):
        self.seq = seq
        self.heavy = heavy
        if chain_hint is None and not heavy:
            # direct K-vs-L profile comparison (never 'H' for a declared
            # light chain; low-margin lambda calls no longer forced kappa)
            chain_hint, _ = AL.classify_light(seq)
        placed = IMGT.grid_string(seq, heavy=heavy,
                                  chain_hint=chain_hint or 'H')
        if placed is None:
            raise ValueError(f'unalignable chain: {seq[:20]}...')
        self.grid = np.asarray(list(placed['grid']))
        self.aho = placed['aho']
        if heavy:
            self.vernier = C.HEAVY_CDR_KABAT_VERNIER == 5
            self.kabat_cdr = np.isin(C.HEAVY_CDR_KABAT_VERNIER, (1, 2, 3))
            self.imgt_cdr = C.HEAVY_CDR_INDEX != 0
        else:
            self.vernier = C.LIGHT_CDR_KABAT_VERNIER == 5
            self.kabat_cdr = np.isin(C.LIGHT_CDR_KABAT_VERNIER, (1, 2, 3))
            self.imgt_cdr = C.LIGHT_CDR_INDEX != 0

    def occupied(self) -> np.ndarray:
        return self.grid != '-'


def _joint_positions(*chains: GridChain) -> np.ndarray:
    occ = chains[0].occupied()
    for ch in chains[1:]:
        occ = occ | ch.occupied()
    return occ


def all_preservation(a: GridChain, b: GridChain) -> float:
    """Identity over all aligned positions (patent_eval.cal_all_preservation,
    :156-165)."""
    occ = _joint_positions(a, b)
    return float((a.grid[occ] == b.grid[occ]).mean())


def fr_preservation(a: GridChain, b: GridChain, scheme: str = 'imgt') -> float:
    """Identity over non-CDR positions (cal_fr_preservation, :137-153)."""
    cdr = a.imgt_cdr if scheme == 'imgt' else a.kabat_cdr
    occ = _joint_positions(a, b) & ~cdr
    return float((a.grid[occ] == b.grid[occ]).mean())


def vernier_preservation(a: GridChain, b: GridChain) -> float:
    """Identity over Kabat vernier-zone positions (cal_vernier_preservation,
    :168-177)."""
    occ = _joint_positions(a, b) & a.vernier
    if occ.sum() == 0:
        return 1.0
    return float((a.grid[occ] == b.grid[occ]).mean())


def mutation_precision(exp: GridChain, parental: GridChain, test: GridChain,
                       vernier_only: bool = False) -> Optional[float]:
    """Of positions mutated (vs parental) by either the experimental or the
    sampled sequence, the fraction where both made the same change
    (cal_fr_mutation_precision :17-39 / cal_vernier_mutation_precision
    :62-87). None when neither mutated anything in scope."""
    occ = _joint_positions(exp, parental, test)
    if vernier_only:
        occ = occ & exp.vernier
    share = only = 0
    for i in np.nonzero(occ)[0]:
        e, m, s = exp.grid[i], parental.grid[i], test.grid[i]
        if e != m or s != m:
            if e == s:
                share += 1
            else:
                if s != m:
                    only += 1
    if share + only == 0:
        return None
    return share / (share + only)


def consensus_identity(chain: GridChain) -> float:
    """FR identity vs the human chain-type consensus, compared on the AHo
    grid (both are AHo-aligned, so columns correspond directly).

    Stand-in for abnumber's germline-graft identity
    (cal_group_fr_germline_identity, patent_eval.py:203-213) when no germline
    database is available: the AHo consensus acts as the pseudo-germline.
    """
    profile = 'H' if chain.heavy else AL.detect_chain_type(chain.seq)[1]
    from ..numbering import consensus as CONS
    cons = CONS.CONSENSUS[profile][0]
    fr_cols = np.asarray(C.AHO_CDR_INDEX) == 0
    a = np.asarray(list(chain.aho))
    b = np.asarray(list(cons))
    occ = fr_cols & ((a != '-') | (b != '-'))
    if occ.sum() == 0:
        return 0.0
    return float((a[occ] == b[occ]).mean())


# ---------------------------------------------------------------------------
# Batched metric groups (patent_eval.py:180-213 group functions)
# ---------------------------------------------------------------------------

def group_preservation(human_pairs: Sequence[Tuple[str, str]],
                       mouse_pairs: Sequence[Tuple[str, str]]
                       ) -> Dict[str, List[float]]:
    out = {'h_all': [], 'l_all': [], 'h_vernier': [], 'l_vernier': []}
    for (hh, hl), (mh, ml) in zip(human_pairs, mouse_pairs):
        try:
            a_h, b_h = GridChain(hh, True, 'H'), GridChain(mh, True, 'H')
            a_l, b_l = GridChain(hl, False), GridChain(ml, False)
        except ValueError:
            continue
        out['h_all'].append(all_preservation(a_h, b_h))
        out['l_all'].append(all_preservation(a_l, b_l))
        out['h_vernier'].append(vernier_preservation(a_h, b_h))
        out['l_vernier'].append(vernier_preservation(a_l, b_l))
    return out


def group_mutation_precision(exp_pairs, mouse_pairs, sample_pairs,
                             vernier_only: bool = False
                             ) -> Dict[str, List[float]]:
    out = {'h': [], 'l': []}
    for (eh, el), (mh, ml), (sh, sl) in zip(exp_pairs, mouse_pairs,
                                            sample_pairs):
        try:
            ch = mutation_precision(GridChain(eh, True, 'H'),
                                    GridChain(mh, True, 'H'),
                                    GridChain(sh, True, 'H'),
                                    vernier_only=vernier_only)
            cl = mutation_precision(GridChain(el, False),
                                    GridChain(ml, False),
                                    GridChain(sl, False),
                                    vernier_only=vernier_only)
        except ValueError:
            continue
        if ch is not None:
            out['h'].append(ch)
        if cl is not None:
            out['l'].append(cl)
    return out


# ---------------------------------------------------------------------------
# Germline-graft metrics (patent_eval.py:203-213; utils/evaluation.py:349-381)
# ---------------------------------------------------------------------------

def _chain_group(chain: GridChain) -> str:
    if chain.heavy:
        return 'H'
    group, _ = AL.classify_light(chain.seq)
    return group


def germline_graft(chain: GridChain, backmutate_vernier: bool = False):
    """Nearest-germline CDR graft of this chain
    (abnumber graft_cdrs_onto_human_germline equivalent; see
    numbering/germline.py for the embedded library)."""
    from ..numbering import germline as G
    return G.graft_cdrs(chain.grid, _chain_group(chain),
                        backmutate_vernier=backmutate_vernier)


def germline_identity(chain: GridChain) -> float:
    """FR identity between a chain and its own germline graft
    (cal_group_fr_germline_identity, patent_eval.py:203-213). Delegates to
    the single grid-level implementation in numbering/germline.py."""
    from ..numbering import germline as G
    return G.fr_identity_grid(chain.grid, _chain_group(chain))


def annotate_conservation(parental: str, pred: str, germline: str) -> str:
    """Per-position conservation category
    (utils/evaluation.py annotate_conservation, :349-357)."""
    if parental == pred:
        if parental == germline:
            return 'Conserved'
        return 'Back-mutated'
    if pred == germline:
        return 'Humanized'
    return 'Engineered'


def collect_positions(parental: GridChain, pred: GridChain,
                      name: str = '') -> List[Dict]:
    """Position-level conservation table vs the parental chain's germline
    graft (utils/evaluation.py collect_position(s), :360-381)."""
    germ = germline_graft(parental)['grid']
    positions = C.HEAVY_POSITIONS if parental.heavy else C.LIGHT_POSITIONS
    region_idx = (C.HEAVY_REGION_INDEX if parental.heavy
                  else C.LIGHT_REGION_INDEX)
    region_names = ('FR1', 'CDR1', 'FR2', 'CDR2', 'FR3', 'CDR3', 'FR4')
    occ = parental.occupied() | pred.occupied() | (germ != '-')
    rows = []
    for i in np.nonzero(occ)[0]:
        rows.append({
            'name': name,
            'pos': positions[i],
            'chain': 'Heavy' if parental.heavy else 'Light',
            'region': region_names[region_idx[i]],
            'in_vernier': bool(parental.vernier[i]),
            'parental': parental.grid[i],
            'predicted': pred.grid[i],
            'germline': germ[i],
            'conservation': annotate_conservation(
                parental.grid[i], pred.grid[i], germ[i]),
        })
    return rows
