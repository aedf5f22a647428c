# Copied from hudiff_tpu/numbering/align.py without the native aligner path.
"""Needleman-Wunsch alignment of a query sequence onto the 149-column AHo
grid, anchored by chain-type consensus sequences.

Replaces the external ANARCI/HMMER dependency for numbering
(reference dataset/abnativ_alignment/align_and_clean.py:11-126 drives
anarci.anarci). Scoring: BLOSUM62 vs the consensus residue, weighted by the
per-column conservation index; skipping a column (query deletion) is cheap in
CDR columns (designed to be empty) and expensive at conserved anchors;
insertions relative to the 149-column grid are not representable and abort
the alignment (the reference likewise drops such sequences).

Only the pure-Python DP is kept here; the JAX package's optional native
aligner (csrc/aligner.cc) is not carried over.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .. import constants as C
from . import consensus as CONS

# BLOSUM62 over the 20 sorted 1-letter residues (standard public matrix).
_B62 = """
A  4 C  0 D -2 E -1 F -2 G  0 H -2 I -1 K -1 L -1 M -1 N -2 P -1 Q -1 R -1 S  1 T  0 V  0 W -3 Y -2
C  0 C  9 D -3 E -4 F -2 G -3 H -3 I -1 K -3 L -1 M -1 N -3 P -3 Q -3 R -3 S -1 T -1 V -1 W -2 Y -2
D -2 C -3 D  6 E  2 F -3 G -1 H -1 I -3 K -1 L -4 M -3 N  1 P -1 Q  0 R -2 S  0 T -1 V -3 W -4 Y -3
E -1 C -4 D  2 E  5 F -3 G -2 H  0 I -3 K  1 L -3 M -2 N  0 P -1 Q  2 R  0 S  0 T -1 V -2 W -3 Y -2
F -2 C -2 D -3 E -3 F  6 G -3 H -1 I  0 K -3 L  0 M  0 N -3 P -4 Q -3 R -3 S -2 T -2 V -1 W  1 Y  3
G  0 C -3 D -1 E -2 F -3 G  6 H -2 I -4 K -2 L -4 M -3 N  0 P -2 Q -2 R -2 S  0 T -2 V -3 W -2 Y -3
H -2 C -3 D -1 E  0 F -1 G -2 H  8 I -3 K -1 L -3 M -2 N  1 P -2 Q  0 R  0 S -1 T -2 V -3 W -2 Y  2
I -1 C -1 D -3 E -3 F  0 G -4 H -3 I  4 K -3 L  2 M  1 N -3 P -3 Q -3 R -3 S -2 T -1 V  3 W -3 Y -1
K -1 C -3 D -1 E  1 F -3 G -2 H -1 I -3 K  5 L -2 M -1 N  0 P -1 Q  1 R  2 S  0 T -1 V -2 W -3 Y -2
L -1 C -1 D -4 E -3 F  0 G -4 H -3 I  2 K -2 L  4 M  2 N -3 P -3 Q -2 R -2 S -2 T -1 V  1 W -2 Y -1
M -1 C -1 D -3 E -2 F  0 G -3 H -2 I  1 K -1 L  2 M  5 N -2 P -2 Q  0 R -1 S -1 T -1 V  1 W -1 Y -1
N -2 C -3 D  1 E  0 F -3 G  0 H  1 I -3 K  0 L -3 M -2 N  6 P -2 Q  0 R  0 S  1 T  0 V -3 W -4 Y -2
P -1 C -3 D -1 E -1 F -4 G -2 H -2 I -3 K -1 L -3 M -2 N -2 P  7 Q -1 R -2 S -1 T -1 V -2 W -4 Y -3
Q -1 C -3 D  0 E  2 F -3 G -2 H  0 I -3 K  1 L -2 M  0 N  0 P -1 Q  5 R  1 S  0 T -1 V -2 W -2 Y -1
R -1 C -3 D -2 E  0 F -3 G -2 H  0 I -3 K  2 L -2 M -1 N  0 P -2 Q  1 R  5 S -1 T -1 V -3 W -3 Y -2
S  1 C -1 D  0 E  0 F -2 G  0 H -1 I -2 K  0 L -2 M -1 N  1 P -1 Q  0 R -1 S  4 T  1 V -2 W -3 Y -2
T  0 C -1 D -1 E -1 F -2 G -2 H -2 I -1 K -1 L -1 M -1 N  0 P -1 Q -1 R -1 S  1 T  5 V  0 W -2 Y -2
V  0 C -1 D -3 E -2 F -1 G -3 H -3 I  3 K -2 L  1 M  1 N -3 P -2 Q -2 R -3 S -2 T  0 V  4 W -3 Y -1
W -3 C -2 D -4 E -3 F  1 G -2 H -2 I -3 K -3 L -2 M -1 N -4 P -4 Q -2 R -3 S -3 T -2 V -3 W 11 Y  2
Y -2 C -2 D -3 E -2 F  3 G -3 H  2 I -1 K -2 L -1 M -1 N -2 P -3 Q -1 R -2 S -2 T -2 V -1 W  2 Y  7
"""


def _build_blosum() -> Dict[Tuple[str, str], float]:
    """Each row lists (column-residue, score) pairs; the first column residue
    is the row residue itself."""
    mat: Dict[Tuple[str, str], float] = {}
    for row in _B62.strip().split('\n'):
        parts = row.split()
        row_aa = parts[0]
        for k in range(0, len(parts), 2):
            col_aa, v = parts[k], float(parts[k + 1])
            mat[(row_aa, col_aa)] = v
            mat[(col_aa, row_aa)] = v
    return mat


BLOSUM62 = _build_blosum()

# AHo column classes (0-based): CDR columns are cheap to skip; conserved
# framework anchors are expensive.
_AHO_CDR_COLS = set(range(26, 42)) | set(range(56, 69)) | set(range(107, 137))
_ANCHOR_COLS = {22, 105}  # conserved cysteines (AHo positions 23, 106)


def _column_costs(conservation) -> np.ndarray:
    """Per-column cost of leaving the column empty."""
    cost = np.empty(C.AHO_LEN, np.float64)
    for j in range(C.AHO_LEN):
        if j in _ANCHOR_COLS:
            cost[j] = 12.0
        elif j in _AHO_CDR_COLS:
            cost[j] = 0.2
        else:
            cost[j] = 2.0 + 2.0 * float(conservation[j])
    return cost


_PROFILE_CACHE: Dict[str, tuple] = {}


def _profile(chain_type: str):
    if chain_type not in _PROFILE_CACHE:
        cons_seq, conservation = CONS.CONSENSUS[chain_type]
        score = np.zeros((C.AHO_LEN, 20), np.float64)
        for j, (c, w) in enumerate(zip(cons_seq, conservation)):
            if c == '-':
                for k, q in enumerate(C.AA_1):
                    score[j, k] = -0.5  # weak penalty for occupying gap columns
            else:
                for k, q in enumerate(C.AA_1):
                    score[j, k] = BLOSUM62[(q, c)] * (0.5 + float(w))
        _PROFILE_CACHE[chain_type] = (score, _column_costs(conservation))
    return _PROFILE_CACHE[chain_type]


def align_to_aho(seq: str, chain_type: str = 'H') -> Optional[Tuple[str, float]]:
    """Globally align ``seq`` onto the 149 AHo columns.

    Returns (aligned 149-char string with '-' gaps, score) or None when the
    sequence cannot be embedded (too long / non-standard residues).
    """
    try:
        q_idx = [C.AA_1.index(a) for a in seq]
    except ValueError:
        q_idx = []
        for a in seq:
            if a == 'X':
                q_idx.append(-1)
            elif a in C.AA_1:
                q_idx.append(C.AA_1.index(a))
            else:
                return None
    n = len(q_idx)
    if n > C.AHO_LEN:
        return None
    score_mat, skip_cost = _profile(chain_type)

    NEG = -1e12
    m = C.AHO_LEN
    # dp[i, j]: best score aligning first i query residues to first j columns;
    # residues must map to columns in order, no insertions.
    dp = np.full((n + 1, m + 1), NEG)
    dp[0, 0] = 0.0
    back = np.zeros((n + 1, m + 1), np.int8)  # 1 = residue in column, 2 = skip column
    for j in range(1, m + 1):
        dp[0, j] = dp[0, j - 1] - skip_cost[j - 1]
        back[0, j] = 2
    match = np.empty((n, m))
    for i in range(n):
        if q_idx[i] >= 0:
            match[i] = score_mat[:, q_idx[i]]
        else:
            match[i] = 0.0
    for i in range(1, n + 1):
        for j in range(i, m + 1):  # need j >= i to place i residues
            diag = dp[i - 1, j - 1] + match[i - 1, j - 1]
            skip = dp[i, j - 1] - skip_cost[j - 1]
            if diag >= skip:
                dp[i, j] = diag
                back[i, j] = 1
            else:
                dp[i, j] = skip
                back[i, j] = 2
    if dp[n, m] <= NEG / 2:
        return None
    # traceback
    cols = [-1] * m
    i, j = n, m
    while j > 0:
        if back[i, j] == 1:
            cols[j - 1] = i - 1
            i -= 1
        j -= 1
    aligned = ''.join(seq[k] if k >= 0 else '-' for k in cols)
    return aligned, float(dp[n, m])


# Invariant AHo anchors shared by every chain profile (consensus column,
# expected residue): the Cys23/Cys106 disulfide pair and Trp43. A SHIFTED
# (mis-gridded) alignment misplaces all three at once; a legitimate point
# mutation in an engineered framework loses at most one — so the gate
# requires 2 of 3, rejecting frame-shifts without rejecting real variants.
ANCHORS = ((22, 'C'), (42, 'W'), (105, 'C'))


def alignment_anchors_ok(aligned: str) -> bool:
    """True when the 149-char AHo alignment places >= 2 of the 3 invariant
    anchors (X = unknown residue counts as a match)."""
    hits = sum(1 for col, aa in ANCHORS if aligned[col] in (aa, 'X'))
    return hits >= 2


# Per-residue profile-score floor for accepting a numbering. Measured
# separation: in-family V-domains (human/mouse/rat/rabbit, right profile)
# score >= 4.1/residue; V-domains against the WRONG chain profile ~1.7;
# non-antibody proteins (lysozyme), shuffled chains, and poly-A all < 0.8.
# 1.2 rejects everything that is not a V-domain with a 3x margin on both
# sides (this plays the role of ANARCI's HMM e-value gate).
MIN_PER_RESIDUE_SCORE = 1.2


def alignment_quality_ok(aligned: str, score: float, n_residues: int) -> bool:
    """Full mis-grid gate: invariant anchors placed AND the profile score
    clears the non-antibody floor."""
    return (alignment_anchors_ok(aligned)
            and n_residues > 0
            and score / n_residues >= MIN_PER_RESIDUE_SCORE)


def _query_indices(seq: str) -> Optional[list]:
    out = []
    for a in seq:
        if a == 'X':
            out.append(-1)
        elif a in C.AA_1:
            out.append(C.AA_1.index(a))
        else:
            return None
    return out


def align_to_aho_batch(seqs, chain_type: str = 'H'):
    """Batched ``align_to_aho`` over one chain profile.

    Returns a list of (aligned 149-char string, score) / None entries.
    """
    prepared = []
    for seq in seqs:
        q = _query_indices(seq)
        if q is None or len(q) > C.AHO_LEN or len(q) == 0:
            prepared.append(None)
        else:
            prepared.append(q)
    live = [(i, q) for i, q in enumerate(prepared) if q is not None]
    out: list = [None] * len(prepared)
    if not live:
        return out
    for i, _ in live:
        out[i] = align_to_aho(seqs[i], chain_type)
    return out


# Alignment-score floor separating real antibody variable domains (~500 on
# the consensus NW scale) from fragments/non-antibody proteins (<10); used
# wherever ANARCI would have rejected a sequence outright.
MIN_CHAIN_SCORE = 100.0


def profile_scores(seq: str) -> Dict[str, float]:
    """Alignment score of ``seq`` against every chain-type consensus profile
    ('H'/'K'/'L'/'VHH'); profiles the sequence cannot align to are absent."""
    out: Dict[str, float] = {}
    for key in ('H', 'K', 'L', 'VHH'):
        res = align_to_aho(seq, key)
        if res is not None:
            out[key] = float(res[1])
    return out


def detect_chain_type(seq: str, scores: Optional[Dict[str, float]] = None
                      ) -> Tuple[str, str, float]:
    """Best-scoring consensus -> (chain_group 'H'/'K'/'L', profile key, score).

    Pass precomputed ``profile_scores(seq)`` to avoid re-running the four
    NW alignments when the caller also needs classify_light."""
    scores = profile_scores(seq) if scores is None else scores
    if not scores:
        raise ValueError('sequence could not be aligned to any chain profile')
    profile = max(scores, key=scores.get)
    group = 'H' if profile in ('H', 'VHH') else profile
    return group, profile, scores[profile]


# Kappa-vs-lambda decisions below this score margin (consensus NW scale;
# real-domain scores are ~400-600 and typical K/L separation is >100) are
# flagged as ambiguous so callers can warn instead of silently mis-typing
# borderline lambda chains.
LIGHT_MARGIN_AMBIGUOUS = 30.0


def classify_light(seq: str, scores: Optional[Dict[str, float]] = None
                   ) -> Tuple[str, float]:
    """Type a light chain as kappa or lambda by direct K-vs-L profile
    comparison (never 'H', regardless of which profile scores best overall —
    the reference derives the same decision from abnumber's IMGT chain type).

    Returns ``(group, margin)``: group in {'K','L'} and the absolute K-L
    score margin. A margin below ``LIGHT_MARGIN_AMBIGUOUS`` means the call
    is unreliable; callers should surface that instead of trusting it.
    Pass precomputed ``profile_scores(seq)`` to avoid re-aligning.
    """
    scores = profile_scores(seq) if scores is None else scores
    k = scores.get('K', float('-inf'))
    l = scores.get('L', float('-inf'))
    if k == float('-inf') and l == float('-inf'):
        raise ValueError('sequence could not be aligned to K or L profile')
    group = 'K' if k >= l else 'L'
    margin = abs(k - l) if (k > float('-inf') and l > float('-inf')) \
        else float('inf')
    return group, margin


def ambiguous_light_message(group: str, margin: float,
                            context: str = '') -> Optional[str]:
    """THE one threshold + message for a low-margin light-chain call.
    Returns the message when the margin is below LIGHT_MARGIN_AMBIGUOUS,
    else None — so warnings-module callers (warn_ambiguous_light) and
    logger callers (data loaders) render the identical rule."""
    if margin >= LIGHT_MARGIN_AMBIGUOUS:
        return None
    suffix = f' [{context}]' if context else ''
    return (f'ambiguous light-chain type (K-L margin {margin:.1f} < '
            f'{LIGHT_MARGIN_AMBIGUOUS}); proceeding as {group}{suffix}')


def warn_ambiguous_light(group: str, margin: float, context: str = '',
                         stacklevel: int = 3) -> bool:
    """Emit ambiguous_light_message via the warnings module; True if it
    fired."""
    msg = ambiguous_light_message(group, margin, context)
    if msg is None:
        return False
    import warnings
    warnings.warn(msg, stacklevel=stacklevel)
    return True


def _h_minus_best_light(scores: Dict[str, float]) -> float:
    h = scores.get('H', float('-inf'))
    best_light = max(scores.get('K', float('-inf')),
                     scores.get('L', float('-inf')))
    return h - best_light


def is_confident_heavy(scores: Dict[str, float]) -> bool:
    """True when a sequence is CONFIDENTLY a heavy chain: its H profile
    score beats the best light profile by more than LIGHT_MARGIN_AMBIGUOUS.

    This is the gate for heavy-chain-in-a-light-column detection (swapped
    CSV columns, bad pairings): a borderline light chain whose best profile
    mis-scores as H by a few points must NOT be rejected (that would bring
    back a forced-kappa behaviour). Calibration on all 1392
    HuAb348 chains (696 heavy + 696 light, mouse + humanized): heavy
    margins span [+156, +553] (median +288), light margins [-553, -133]
    (median -330) — the 30.0 threshold sits >100 points clear of both
    distributions."""
    return _h_minus_best_light(scores) > LIGHT_MARGIN_AMBIGUOUS


def is_confident_light(scores: Dict[str, float]) -> bool:
    """Symmetric gate for light-chain-in-a-heavy-slot detection: the best
    light profile beats H by more than LIGHT_MARGIN_AMBIGUOUS (same
    HuAb348 calibration as is_confident_heavy — real light chains clear
    this by >100 points, borderline heavies never do)."""
    return _h_minus_best_light(scores) < -LIGHT_MARGIN_AMBIGUOUS
