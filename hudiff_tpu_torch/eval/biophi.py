# Copied from hudiff_tpu/eval/biophi.py (csv in place of pandas for the sample CSV).
"""BioPhi/OASis export: sample CSV -> paired FASTA.

Rebuilds evaluation/Biophi_eval.py:28-43 (and the fasta writer used at
antibody_scripts/sample.py:43-54) without the abnumber dependency.
"""
from __future__ import annotations

from typing import Iterable, Tuple


def write_pair_fasta(pairs: Iterable[Tuple[str, str, str]], path: str) -> None:
    """pairs: iterable of (name, h_seq, l_seq)."""
    with open(path, 'w') as f:
        for name, h_seq, l_seq in pairs:
            f.write(f'>{name}_VH VH\n{h_seq}\n')
            f.write(f'>{name}_VL VL\n{l_seq}\n')


def sample_csv_to_fasta(sample_csv: str, out_path: str,
                        version: str = 'v001') -> str:
    import csv
    with open(sample_csv, newline='') as f:
        human = [r for r in csv.DictReader(f) if r['Specific'] == 'humanization']
    pairs = [(f'{version}human{i}', r['hseq'], r['lseq'])
             for i, r in enumerate(human)]
    write_pair_fasta(pairs, out_path)
    return out_path


# ---------------------------------------------------------------------------
# OASis identity (reference patent_eval.py:258-277: biophi subprocess + xlsx)
# ---------------------------------------------------------------------------

def run_oasis(fasta_path: str, oasis_db: str, output_xlsx: str,
              exec_path: str = 'biophi'):
    """Run BioPhi OASis over a paired FASTA -> xlsx report path, or None
    when the biophi executable is unavailable (external tool; optional)."""
    import os
    import shutil
    import subprocess
    if os.path.exists(output_xlsx):
        return output_xlsx
    if shutil.which(exec_path) is None and not os.path.exists(exec_path):
        return None
    proc = subprocess.Popen(
        [exec_path, 'oasis', fasta_path, '--oasis-db', oasis_db,
         '--output', output_xlsx],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    proc.communicate()
    return output_xlsx if os.path.exists(output_xlsx) else None


def oasis_curve_mean(xlsx_path: str, percentile: str = '50%') -> float:
    """Mean OASis identity at a prevalence percentile from the report's
    'OASis Curves' sheet (patent_eval.py:271-277 uses the 50% column)."""
    import pandas as pd
    curves = pd.read_excel(xlsx_path, sheet_name='OASis Curves', index_col=0)
    return float(curves[percentile].mean())


def read_fasta(path: str):
    """Minimal FASTA reader: [(header, seq), ...] (BioPython-free)."""
    out = []
    name, chunks = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith('>'):
                if name is not None:
                    out.append((name, ''.join(chunks)))
                name, chunks = line[1:], []
            else:
                chunks.append(line)
    if name is not None:
        out.append((name, ''.join(chunks)))
    return out


def pair_from_fasta(path: str) -> Tuple[str, str]:
    """First VH/VL pair from a complex FASTA
    (sample_for_anti_cdr.get_h_l_seq_from_fasta, :53-70)."""
    records = read_fasta(path)
    h_seq = l_seq = None
    from ..numbering import align as AL
    for header, seq in records:
        tag = header.upper()
        if 'HEAVY' in tag or 'VH' in tag:
            h_seq = h_seq or seq
            continue
        if 'LIGHT' in tag or 'VL' in tag or 'VK' in tag:
            l_seq = l_seq or seq
            continue
        # untagged record: detect by alignment; non-antibody chains in a
        # complex FASTA (antigens etc.) simply don't align -> skip them
        try:
            group, _, score = AL.detect_chain_type(seq)
        except ValueError:
            continue
        # weak alignments are non-antibody chains that happened to embed
        if score < AL.MIN_CHAIN_SCORE:
            continue
        if group == 'H':
            h_seq = h_seq or seq
        else:
            l_seq = l_seq or seq
    if h_seq is None or l_seq is None:
        raise ValueError(f'FASTA {path} does not contain a VH/VL pair')
    return h_seq, l_seq
