# Copied from hudiff_tpu/constants.py.
"""Domain constants: amino-acid vocabulary, IMGT/AHo position grids, CDR masks.

These tables are *data*, not code: they describe the fixed IMGT-numbered grid
HuDiff operates on (heavy chain = 152 slots, light chain = 139 slots) and the
region annotations used for masking/conditioning. The values mirror the
reference semantics (the reference's dataset/preprocess.py:178-374 and
dataset/oas_pair_dataset_new.py:25-40) but are generated
programmatically from segment descriptions rather than spelled out literally,
so internal consistency is enforced by construction.

All tables are numpy arrays; device code converts them as needed.
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Amino-acid vocabulary
# ---------------------------------------------------------------------------
# 20 canonical residues in sorted 1-letter order, then 'X' (unknown), the grid
# pad token '-', and the diffusion mask token '<msk>'.
# Reference: utils/tokenizer.py:34-62.
AA_1 = ('A', 'C', 'D', 'E', 'F', 'G', 'H', 'I', 'K', 'L',
        'M', 'N', 'P', 'Q', 'R', 'S', 'T', 'V', 'W', 'Y')
AA_1TO3 = {
    'A': 'ALA', 'R': 'ARG', 'N': 'ASN', 'D': 'ASP', 'C': 'CYS',
    'Q': 'GLN', 'E': 'GLU', 'G': 'GLY', 'H': 'HIS', 'I': 'ILE',
    'L': 'LEU', 'K': 'LYS', 'M': 'MET', 'F': 'PHE', 'P': 'PRO',
    'S': 'SER', 'T': 'THR', 'W': 'TRP', 'Y': 'TYR', 'V': 'VAL',
}
AA_3TO1 = {v: k for k, v in AA_1TO3.items()}

TOK_X = 'X'
TOK_PAD = '-'
TOK_MSK = '<msk>'
TOKENS = (*AA_1, TOK_X, TOK_PAD, TOK_MSK)          # 23 tokens
N_TOKENS = len(TOKENS)                              # 23
IDX_X = TOKENS.index(TOK_X)                         # 20
IDX_PAD = TOKENS.index(TOK_PAD)                     # 21
IDX_MSK = TOKENS.index(TOK_MSK)                     # 22
N_AA = len(AA_1)                                    # 20

# AbNatiV one-hot alphabet: the same 20 residues followed by the gap '-'.
# Grid token ids 0..19 therefore coincide with AbNatiV channels 0..19;
# the grid pad (21) maps to the AbNatiV gap channel (20).
ABNATIV_ALPHABET = (*AA_1, '-')
ABNATIV_ALPHABET_SIZE = len(ABNATIV_ALPHABET)       # 21
ABNATIV_GAP_IDX = 20

# Chain-type ids (utils/tokenizer.py:141-149): H=0, Lambda=1, Kappa=2.
CHAIN_TYPES = {'H': 0, 'L': 1, 'K': 2}

# ---------------------------------------------------------------------------
# IMGT position grids
# ---------------------------------------------------------------------------
# Heavy grid: IMGT positions 1..111, the 111A..111L / 112L..112A CDR-H3
# insertion ladder, then 112..128.  152 slots total.
# Light grid: 1..111, 111A..111F / 112F..112A, then 112..127.  139 slots.
# Reference: dataset/preprocess.py:195-212 (heavy), :294-309 (light).
_H3_INSERT_H = [f'111{c}' for c in 'ABCDEFGHIJKL'] + [f'112{c}' for c in 'LKJIHGFEDCBA']
_H3_INSERT_L = [f'111{c}' for c in 'ABCDEF'] + [f'112{c}' for c in 'FEDCBA']

HEAVY_POSITIONS = tuple(
    [str(i) for i in range(1, 112)] + _H3_INSERT_H + [str(i) for i in range(112, 129)]
)
LIGHT_POSITIONS = tuple(
    [str(i) for i in range(1, 112)] + _H3_INSERT_L + [str(i) for i in range(112, 128)]
)
HEAVY_POSITIONS_IDX = {p: i for i, p in enumerate(HEAVY_POSITIONS)}
LIGHT_POSITIONS_IDX = {p: i for i, p in enumerate(LIGHT_POSITIONS)}

HEAVY_LEN = len(HEAVY_POSITIONS)    # 152
LIGHT_LEN = len(LIGHT_POSITIONS)    # 139
PAIR_LEN = HEAVY_LEN + LIGHT_LEN    # 291
AHO_LEN = 149                       # AHo-aligned single-chain length
AHO_PAIR_LEN = 2 * AHO_LEN          # 298

# Grid geometry used by the fine-tune IMGT->AHo transfer
# (model/encoder/model.py:404-423, model/nanoencoder/model.py:370-376).
IMGT_HEAVY_TAIL = 150       # heavy grid slots >=150 are the "tail" (pos 127,128)
IMGT_LIGHT_TAIL = 290       # index of the light tail slot within the 291 grid
AHO_HEAVY_TAIL = 147        # AHo slots >=147 are the heavy tail
AHO_LIGHT_TAIL = 296        # index of the light tail within the 298 AHo pair


def _rle(segments) -> np.ndarray:
    """Expand [(value, count), ...] run-length segments into an int32 array."""
    out = np.concatenate([np.full(n, v, dtype=np.int32) for v, n in segments])
    return out


def _with_values(base: np.ndarray, index_to_value: dict) -> np.ndarray:
    out = base.copy()
    for i, v in index_to_value.items():
        out[i] = v
    return out


# IMGT segment lengths on the fixed grids (FR1, CDR1, FR2, CDR2, FR3, CDR3, FR4).
HEAVY_SEGMENTS = (26, 12, 17, 10, 39, 37, 11)
LIGHT_SEGMENTS = (26, 12, 17, 10, 39, 25, 10)
AHO_SEGMENTS = (26, 16, 14, 13, 38, 31, 11)

# Region-type conditioning vectors: 0..6 per segment
# (dataset/oas_pair_dataset_new.py:25-40).
HEAVY_REGION_INDEX = _rle(zip(range(7), HEAVY_SEGMENTS))
LIGHT_REGION_INDEX = _rle(zip(range(7), LIGHT_SEGMENTS))


def _cdr_table(segments) -> np.ndarray:
    """IMGT CDR annotation: FRs are 0, CDR1/2/3 are 1/2/3.

    The reference heavy/light tables place a stray FR slot directly after
    CDR2 (the 10 '2's are followed by a 0 before FR3); this is reproduced by
    construction since CDR2 really spans 10 slots within the 17+10+39 block.
    """
    fr1, cdr1, fr2, cdr2, fr3, cdr3, fr4 = segments
    return _rle([(0, fr1), (1, cdr1), (0, fr2), (2, cdr2), (0, fr3), (3, cdr3), (0, fr4)])


# Plain IMGT CDR masks (dataset/preprocess.py:214-233, :311-330).
HEAVY_CDR_INDEX = _cdr_table(HEAVY_SEGMENTS)
LIGHT_CDR_INDEX = _cdr_table(LIGHT_SEGMENTS)
AHO_CDR_INDEX = _cdr_table(AHO_SEGMENTS)

# "No tail" variants mark the trailing grid slots with 4 so they are never
# sampled (preprocess.py:224-233, :321-330).
HEAVY_CDR_INDEX_NO_TAIL = _with_values(HEAVY_CDR_INDEX, {150: 4, 151: 4})
LIGHT_CDR_INDEX_NO_TAIL = _with_values(LIGHT_CDR_INDEX, {138: 4})

# --- Kabat-scheme CDR masks with/without vernier-zone marks --------------
# Kabat CDR spans expressed as slots of the IMGT grid, plus the vernier-zone
# positions (value 5) used when humanizing with vernier residues frozen.
# Reference: preprocess.py:237-265 (heavy), :332-362 (light).
_H_KABAT_CDR1 = range(26, 40)        # 14 slots
_H_KABAT_CDR2 = range(54, 74)        # 20 slots
_H_KABAT_CDR3 = range(104, 141)      # 37 slots
_H_TAIL = (150, 151)
_H_VERNIER = (51, 52, 53, 75, 77, 79, 81, 86)

_L_KABAT_CDR1 = range(23, 40)        # 17 slots
_L_KABAT_CDR2 = range(55, 69)        # 14 slots
_L_KABAT_CDR3 = range(104, 129)      # 25 slots
_L_TAIL = (138,)
_L_VERNIER = (77, 79, 83, 84, 86)
# Light slots 51..54 carry the vernier mark in BOTH tables ("observe the
# situation" comment at preprocess.py:354): they stay frozen even when
# vernier sampling is enabled.
_L_ALWAYS_VERNIER = (51, 52, 53, 54)


def _kabat_table(length, cdr1, cdr2, cdr3, tail, vernier) -> np.ndarray:
    out = np.zeros(length, dtype=np.int32)
    out[list(cdr1)] = 1
    out[list(cdr2)] = 2
    out[list(cdr3)] = 3
    out[list(tail)] = 4
    out[list(vernier)] = 5
    return out


HEAVY_CDR_KABAT_VERNIER = _kabat_table(
    HEAVY_LEN, _H_KABAT_CDR1, _H_KABAT_CDR2, _H_KABAT_CDR3, _H_TAIL, _H_VERNIER)
HEAVY_CDR_KABAT_NO_VERNIER = _kabat_table(
    HEAVY_LEN, _H_KABAT_CDR1, _H_KABAT_CDR2, _H_KABAT_CDR3, _H_TAIL, ())
LIGHT_CDR_KABAT_VERNIER = _kabat_table(
    LIGHT_LEN, _L_KABAT_CDR1, _L_KABAT_CDR2, _L_KABAT_CDR3, _L_TAIL,
    _L_ALWAYS_VERNIER + _L_VERNIER)
LIGHT_CDR_KABAT_NO_VERNIER = _kabat_table(
    LIGHT_LEN, _L_KABAT_CDR1, _L_KABAT_CDR2, _L_KABAT_CDR3, _L_TAIL,
    _L_ALWAYS_VERNIER)

# Inpaint (germline-graft) heavy mask: wider CDR2 (54..65), plus four FR2
# anchor slots marked 4 that stay frozen (preprocess.py:269-277).
_H_INPAINT_CDR2 = range(54, 66)
_H_INPAINT_ANCHORS = (41, 48, 49, 51)
INPAINT_HEAVY_CDR_INDEX = _kabat_table(
    HEAVY_LEN, range(26, 38), _H_INPAINT_CDR2, _H_KABAT_CDR3, (), ())
INPAINT_HEAVY_CDR_INDEX[list(_H_INPAINT_ANCHORS)] = 4

# OAS column segment names per chain locus (dataset/preprocess.py:21-25).
SEG_NAMES = {
    'H': ('fwh1', 'cdrh1', 'fwh2', 'cdrh2', 'fwh3', 'cdrh3', 'fwh4'),
    'K': ('fwk1', 'cdrk1', 'fwk2', 'cdrk2', 'fwk3', 'cdrk3', 'fwk4'),
    'L': ('fwl1', 'cdrl1', 'fwl2', 'cdrl2', 'fwl3', 'cdrl3', 'fwl4'),
}

# AbNatiV linear-rescale thresholds (model/nanoencoder/abnativ_scoring.py:117)
# and eval reference means (nanobody_scripts/nano_eval.py:65-66).
ABNATIV_BEST_THRESHOLDS = {
    'VH': 0.988047, 'VKappa': 0.992496, 'VLambda': 0.985580, 'VHH': 0.990973,
}
ABNATIV_RESCALE_TARGET = 0.8
NANO_EVAL_REF_VH_SCORE = 0.7378085839359757
NANO_EVAL_REF_VHH_SCORE = 0.9143594023426274

__all__ = [n for n in dir() if not n.startswith('_')]
