# Copied from hudiff_tpu/numbering/regions.py.
"""Per-residue region labels (reference utils/anti_numbering.get_regions,
:4-58: subprocess ANARCI -> fr1/cdr1/... labels per residue)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .. import constants as C
from . import imgt as IMGT

_REGION_NAMES = ('fr1', 'cdr1', 'fr2', 'cdr2', 'fr3', 'cdr3', 'fr4')


def get_regions(seq: str, heavy: bool = True, chain_hint: Optional[str] = None
                ) -> Optional[List[Tuple[str, str]]]:
    """[(residue, region_name), ...] for each residue of ``seq``."""
    placed = IMGT.grid_string(seq, heavy=heavy, chain_hint=chain_hint)
    if placed is None:
        return None
    region_idx = (C.HEAVY_REGION_INDEX if heavy else C.LIGHT_REGION_INDEX)
    out = []
    for slot, aa in enumerate(placed['grid']):
        if aa != '-':
            out.append((aa, _REGION_NAMES[region_idx[slot]]))
    return out


def region_sequences(seq: str, heavy: bool = True,
                     chain_hint: Optional[str] = None) -> Optional[dict]:
    """{'fr1': 'EVQL...', 'cdr1': ..., ...} split of the chain."""
    labeled = get_regions(seq, heavy=heavy, chain_hint=chain_hint)
    if labeled is None:
        return None
    out = {name: '' for name in _REGION_NAMES}
    for aa, name in labeled:
        out[name] += aa
    return out
