# Copied from hudiff_tpu/numbering/aho.py.
"""AHo alignment API (149-column), reference-compatible call shape.

Replaces anarci_alignments_of_Fv_sequences
(reference dataset/abnativ_alignment/align_and_clean.py:11-126) for the
framework's needs: producing 149-char AHo-aligned sequences for AbNatiV
scoring and the camel/mouse data paths. Uses external ANARCI when available;
otherwise the built-in consensus NW engine.
"""
from __future__ import annotations

from typing import Optional

from .. import constants as C
from . import align as AL


def _try_anarci_aho(seq: str) -> Optional[str]:
    try:
        from anarci import number  # type: ignore
    except ImportError:
        return None
    try:
        numbered, _ = number(seq, scheme='aho')
    except Exception:
        return None
    if not numbered:
        return None
    grid = ['-'] * C.AHO_LEN
    for (idx, ins), aa in numbered:
        if aa == '-' or ins.strip():
            continue
        if 1 <= idx <= C.AHO_LEN:
            grid[idx - 1] = aa
    return ''.join(grid)


def align_aho(seq: str, chain: Optional[str] = None,
              is_VHH: bool = False) -> Optional[str]:
    """Raw sequence -> 149-char AHo alignment, or None on failure."""
    ext = _try_anarci_aho(seq)
    if ext is not None:
        return ext
    if chain is None:
        profile = 'VHH' if is_VHH else 'H'
    elif chain == 'H':
        profile = 'VHH' if is_VHH else 'H'
    else:
        profile = chain
    res = AL.align_to_aho(seq, profile)
    return res[0] if res is not None else None
