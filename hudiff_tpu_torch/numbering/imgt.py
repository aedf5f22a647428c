# Copied from hudiff_tpu/numbering/imgt.py.
"""IMGT grid placement derived from the AHo alignment.

Replaces the `anarci.number(scheme='imgt')` + grid-placement path
(reference antibody_scripts/sample.py:78-139). When the external `anarci`
package is importable it is used directly (exact reference parity);
otherwise placement is derived from the built-in AHo alignment:

1. align the query onto the 149 AHo columns (numbering/align.py);
2. count residues per IMGT region (AHo region columns, with overflow from
   the wider AHo loop definitions spilling into the flanking IMGT FRs);
3. place each region's residues into the fixed IMGT grid with the canonical
   fill rules (FR gaps at known dropout positions, CDR gaps middle-out,
   CDR3 insertion ladder 111A../112A..).

The resulting grids are self-consistent with ops/scheme_transfer.py by
construction (per-sample residue counts match between grids).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import constants as C
from . import align as AL

# AHo column spans per region (0-based, from constants.AHO_SEGMENTS).
AHO_SPANS = {}
_off = 0
for _name, _n in zip(('fr1', 'cdr1', 'fr2', 'cdr2', 'fr3', 'cdr3', 'fr4'),
                     C.AHO_SEGMENTS):
    AHO_SPANS[_name] = (_off, _off + _n)
    _off += _n


def _ends_inward(slots: List[int], k: int) -> List[int]:
    """Occupy k of the given slots: first ceil(k/2) + last floor(k/2)
    (IMGT middle-gap rule for CDR loops)."""
    head = (k + 1) // 2
    tail = k - head
    return slots[:head] + (slots[len(slots) - tail:] if tail else [])


def _fr_fill(slots: List[int], k: int, drop_order: List[int],
             truncate: str = 'front') -> List[int]:
    """Occupy k slots, dropping ``drop_order`` entries first (canonical FR
    dropouts, e.g. IMGT position 10 / 73), then truncating from the given
    end (front = N-terminal truncation for FR1, back = C-terminal for FR4)."""
    avail = list(slots)
    need_drop = len(avail) - k
    for d in drop_order:
        if need_drop <= 0:
            break
        if d in avail:
            avail.remove(d)
            need_drop -= 1
    if need_drop > 0:
        return avail[need_drop:] if truncate == 'front' else avail[:k]
    return avail


def _cdr3_fill(ladder_lo: List[int], ladder_hi: List[int],
               base_lo: List[int], base_hi: List[int], k: int) -> List[int]:
    """CDR3 fill: base positions 105..117 ends-inward; beyond 13 residues the
    insertion ladder (111A.. / ..112A) grows 112-side first (IMGT rule).

    base_lo/base_hi are sequence-ordered slot lists for 105-111 / 112-117;
    ladder_hi is sequence-ordered 112L..112A (last entry = 112A)."""
    base = base_lo + base_hi          # 13 canonical slots in sequence order
    if k <= len(base):
        head = (k + 1) // 2
        tail = k - head
        out = base[:head] + (base[len(base) - tail:] if tail else [])
        return out
    extra = k - len(base)
    n111 = extra // 2
    n112 = extra - n111
    return (base_lo + ladder_lo[:n111]
            + ladder_hi[len(ladder_hi) - n112:] + base_hi)


# Heavy grid geometry (region -> slot lists), from constants tables.
def _heavy_geometry():
    return {
        'fr1': (list(range(0, 26)), [9]),            # drop IMGT pos 10 first
        'cdr1': list(range(26, 38)),
        'fr2': (list(range(38, 55)), []),
        'cdr2': list(range(55, 65)),
        'fr3': (list(range(65, 104)), [72, 80, 81]),  # IMGT 73, 81, 82
        'cdr3': (list(range(104, 111)),               # 105-111
                 list(range(135, 141)),               # 112-117 (sequence order)
                 list(range(111, 123)),               # 111A..111L
                 list(range(123, 135))),              # 112L..112A (slot 134=112A)
        'fr4': (list(range(141, 152)), []),
    }


def _light_geometry():
    return {
        'fr1': (list(range(0, 26)), [9]),
        'cdr1': list(range(26, 38)),
        'fr2': (list(range(38, 55)), []),
        'cdr2': list(range(55, 65)),
        'fr3': (list(range(65, 104)), [72, 80, 81]),
        'cdr3': (list(range(104, 111)),
                 list(range(123, 129)),               # 112-117 (sequence order)
                 list(range(111, 117)),               # 111A..111F
                 list(range(117, 123))),              # 112F..112A
        'fr4': (list(range(129, 139)), []),
    }


def _region_counts(aho: str) -> Dict[str, int]:
    return {name: sum(1 for ch in aho[s:e] if ch != '-')
            for name, (s, e) in AHO_SPANS.items()}


def _imgt_counts(aho_counts: Dict[str, int], heavy: bool
                 ) -> Optional[Dict[str, int]]:
    """AHo region counts -> IMGT region counts.

    The AHo loop definitions are structurally wider than IMGT's; the fixed
    boundary shifts below make the region capacities line up EXACTLY
    (AHo CDR1 16 - 2 edge residues <= spill handles loop inserts;
    AHo CDR2 13 - 1 left - 2 right = IMGT CDR2 10;
    AHo FR3 38 + 2 - 1 = IMGT FR3 39; AHo FR3's last residue is IMGT 105):
    """
    a = dict(aho_counts)
    c: Dict[str, int] = {}
    c['fr1'] = a['fr1']                                       # 26 <-> 26
    m_c1 = min(2, a['cdr1'])                                  # CDR1 right edge
    c['cdr1'] = a['cdr1'] - m_c1
    m_c2l = min(1, a['cdr2'])                                 # CDR2 left edge
    m_c2r = min(2, a['cdr2'] - m_c2l)                         # CDR2 right edge
    c['fr2'] = m_c1 + a['fr2'] + m_c2l
    c['cdr2'] = a['cdr2'] - m_c2l - m_c2r
    m_f3 = min(1, a['fr3'])                                   # FR3 last = IMGT 105
    c['fr3'] = m_c2r + a['fr3'] - m_f3
    c['cdr3'] = m_f3 + a['cdr3']
    c['fr4'] = a['fr4']
    # loop inserts beyond the IMGT CDR1 grid capacity spill into FR2
    if c['cdr1'] > 12:
        c['fr2'] += c['cdr1'] - 12
        c['cdr1'] = 12
    caps = {'fr1': 26, 'cdr1': 12, 'fr2': 17, 'cdr2': 10, 'fr3': 39,
            'cdr3': 37 if heavy else 25, 'fr4': 11 if heavy else 10}
    for name, cap in caps.items():
        if c[name] > cap:
            return None  # not representable on the fixed grid
    return c


def place_on_grid(seq: str, chain_type: str = 'H',
                  profile: Optional[str] = None) -> Optional[Dict[str, object]]:
    """Place a raw chain sequence onto its IMGT grid.

    Returns dict with 'grid' (152/139-char string, '-' padded), 'aho'
    (149-char AHo alignment), 'chain_type'; or None if unalignable.
    """
    heavy = chain_type == 'H'
    res = AL.align_to_aho(seq, profile or chain_type)
    if res is None:
        return None
    aho, _score = res
    if not AL.alignment_quality_ok(aho, _score, len(seq)):
        # defined failure behavior for out-of-family input (rat/rabbit
        # frameworks align fine, keep their anchors, and score >=4/residue;
        # scrambled, frame-shifted, or non-antibody input does not): clean
        # None + loud warning, never a silently mis-gridded chain
        import warnings
        warnings.warn(
            f'rejecting alignment of {seq[:16]}...: invariant AHo anchors '
            '(Cys23/Trp43/Cys106) missing or profile score below the '
            'V-domain floor — likely not a V-domain or a frame-shifted '
            'alignment', stacklevel=2)
        return None
    counts = _imgt_counts(_region_counts(aho), heavy)
    if counts is None:
        return None
    geo = _heavy_geometry() if heavy else _light_geometry()
    length = C.HEAVY_LEN if heavy else C.LIGHT_LEN

    residues = [ch for ch in aho if ch != '-']
    grid = ['-'] * length
    pos = 0
    for name in ('fr1', 'cdr1', 'fr2', 'cdr2', 'fr3', 'cdr3', 'fr4'):
        k = counts[name]
        if name in ('cdr1', 'cdr2'):
            slots = _ends_inward(geo[name], min(k, len(geo[name])))
        elif name == 'cdr3':
            base_lo, base_hi, ladder_lo, ladder_hi = geo['cdr3']
            slots = _cdr3_fill(ladder_lo, ladder_hi, base_lo, base_hi, k)
        else:
            cand, drops = geo[name]
            slots = _fr_fill(cand, min(k, len(cand)), drops,
                             truncate='back' if name == 'fr4' else 'front')
        slots = sorted(slots)
        for s in slots:
            grid[s] = residues[pos]
            pos += 1
    if pos != len(residues):
        return None
    return {'grid': ''.join(grid), 'aho': aho, 'chain_type': chain_type}


def _try_anarci(seq: str):
    try:
        from anarci import number  # type: ignore
    except ImportError:
        return None
    try:
        numbered, chain_type = number(seq, scheme='imgt')
    except Exception:
        return None
    if numbered is False or numbered is None:
        return None
    out = {}
    for (idx, ins), aa in numbered:
        if aa == '-':
            continue
        out[f'{idx}{ins.strip()}'] = aa
    return out, chain_type


def number_to_dict(seq: str, chain_hint: Optional[str] = None
                   ) -> Optional[Tuple[Dict[str, str], str]]:
    """{IMGT label -> residue} + chain type ('H'/'K'/'L').

    Reference get_pad_seq (sample.py:78-90); prefers external ANARCI.
    """
    ext = _try_anarci(seq)
    if ext is not None:
        return ext
    if chain_hint is not None:
        group = chain_hint
        profile = chain_hint
    else:
        group, profile, _ = AL.detect_chain_type(seq)
    placed = place_on_grid(seq, 'H' if group == 'H' else group,
                           profile=profile)
    if placed is None:
        return None
    positions = C.HEAVY_POSITIONS if placed['chain_type'] == 'H' else C.LIGHT_POSITIONS
    # light grids are keyed by 'K'/'L' group but share the light position table
    if group != 'H':
        positions = C.LIGHT_POSITIONS
    out = {}
    for label, aa in zip(positions, placed['grid']):
        if aa != '-':
            out[label] = aa
    return out, group


def grid_string(seq: str, heavy: bool, chain_hint: Optional[str] = None
                ) -> Optional[Dict[str, object]]:
    """Convenience: raw seq -> {'grid', 'aho', 'chain_type'} using detection."""
    if chain_hint:
        profile = chain_hint
        group = 'H' if chain_hint in ('H', 'VHH') else chain_hint
    else:
        group, profile, _ = AL.detect_chain_type(seq)
    if heavy and group != 'H':
        return None
    return place_on_grid(seq, 'H' if heavy else group, profile=profile)
