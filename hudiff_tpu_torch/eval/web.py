# Copied from hudiff_tpu/eval/web.py (csv in place of pandas for the CSVs).
"""Web-service humanness evaluators (optional; require network egress).

Rebuilds the reference's three scrapers with their EXACT protocols:

- T20 (evaluation/T20_eval.py:12-45): GET
  ``https://sam.curiaglobal.com/t20/cgi-bin/blast.py?chain=<vh|vk|vl>&
  region=<1|2>&output=3&seqs=<seq>``, parse
  ``<td>T20 Score:</td><td>SCORE</td>``.
- SHAB Z-score (evaluation/Zscore_eval.py:18-39): GET
  ``http://www.bioinf.org.uk/abs/shab/shab.cgi?aa_sequence=<seq>&
  DB=<human_heavy|human_kappa|human_lambda>``, parse
  ``<h3>The Z-score value of the Query sequence is: SCORE</h3>``.
- Hu-mAb (evaluation/humab_eval.py:39-73): POST
  ``h_sequence_score/l_sequence_score/jobname_score/humanise`` to the OPIG
  SAbPred humab app, wait, GET the redirected result page, and take the
  ``HUMAN`` rows of the first two ``table table-results`` tables.

Chain typing uses the built-in consensus aligner instead of abnumber
(reference: ``Chain(seq, scheme='imgt').chain_type``).

These cross a network boundary and are host-side, optional, and fail soft:
every entry point raises ``WebEvalUnavailable`` when the service cannot be
reached (e.g. in zero-egress environments). The HTTP transport and sleeps
are injectable so protocol correctness is unit-tested against canned
responses without egress (tests/test_torch_eval.py).
"""
from __future__ import annotations

import csv
import os
import re
import time
from html.parser import HTMLParser
from typing import Callable, Dict, List, Optional, Tuple


class WebEvalUnavailable(RuntimeError):
    pass


def _humanization_rows(sample_fpath: str) -> Tuple[List[str], List[Dict[str, str]]]:
    """(header, the rows whose ``Specific`` is 'humanization') of a sample CSV."""
    with open(sample_fpath, newline='') as f:
        reader = csv.DictReader(f)
        return list(reader.fieldnames or ()), [r for r in reader
                                               if r['Specific'] == 'humanization']


def _write_csv(path: str, columns: List[str], rows: List[list]) -> str:
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(columns)
        w.writerows(rows)
    return path


def _beside(sample_fpath: str, name: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(sample_fpath)), name)


# ---------------------------------------------------------------------------
# Injectable transport
# ---------------------------------------------------------------------------

class Response:
    def __init__(self, ok: bool, text: str, url: str, status_code: int = 200):
        self.ok = ok
        self.text = text
        self.url = url
        self.status_code = status_code


def _requests_fetch(url: str, method: str = 'get', data: Optional[dict] = None,
                    timeout: float = 60.0) -> Response:
    try:
        import requests
    except ImportError as e:
        raise WebEvalUnavailable('requests not installed') from e
    try:
        if method == 'post':
            r = requests.post(url, data=data, timeout=timeout)
        else:
            r = requests.get(url, timeout=timeout)
    except Exception as e:  # noqa: BLE001 - fail soft with context
        raise WebEvalUnavailable(f'web evaluation unreachable: {e}') from e
    return Response(r.ok, r.text, r.url, r.status_code)


# Module-level hooks; tests swap these for canned transports / no-op sleeps.
FETCH: Callable[..., Response] = _requests_fetch
SLEEP: Callable[[float], None] = time.sleep


def _chain_type(seq: str) -> str:
    """'H' / 'K' / 'L' via the internal consensus aligner (the reference
    derives it from abnumber's IMGT Chain). Light chains are typed by a
    direct K-vs-L profile comparison; low-margin calls are surfaced with a
    warning since they select which web database the score is fetched from."""
    from ..numbering import align as AL
    scores = AL.profile_scores(seq)
    group, _, _ = AL.detect_chain_type(seq, scores)
    if group == 'H':
        return 'H'
    lgroup, margin = AL.classify_light(seq, scores)
    AL.warn_ambiguous_light(lgroup, margin,
                            context='selects the web-score database')
    return lgroup


# ---------------------------------------------------------------------------
# T20 (evaluation/T20_eval.py)
# ---------------------------------------------------------------------------

T20_URL = ('https://sam.curiaglobal.com/t20/cgi-bin/blast.py?'
           'chain={chain_type}&region={region}&output=3&seqs={seq}')
T20_REGEX = re.compile(r'<td>T20 Score:</td><td>([0-9.]+)</td>')


def get_t20_online(seq: str, region: int = 1, retries: int = 5
                   ) -> Tuple[Optional[float], Optional[str]]:
    """(score, chain_type) for one chain (T20_eval.py:13-45). region=1 full
    sequence (chain from typing), region=2 framework-only (always 'vh')."""
    if region == 1:
        group = _chain_type(seq)
        chain_type = 'vh' if group == 'H' else ('vl' if group == 'L' else 'vk')
    elif region == 2:
        chain_type = 'vh'
    else:
        raise ValueError('Region type do not appropriate.')

    html = None
    url = T20_URL.format(chain_type=chain_type, region=region, seq=seq)
    last: Optional[Exception] = None
    for retry in range(retries):
        try:
            r = FETCH(url)
            if r.ok:
                html = r.text
                break
        except WebEvalUnavailable as e:
            last = e
        SLEEP(0.5 + retry * 5)
    if html is None:
        raise WebEvalUnavailable(f'T20 server unreachable: {last}')
    matches = T20_REGEX.findall(html)
    SLEEP(1)
    if not matches:
        return None, None
    return float(matches[0]), chain_type


def t20_score(seq: str, chain: Optional[str] = None, region: int = 1) -> float:
    """Single-chain T20 humanness; raises when unparseable."""
    score, _ = get_t20_online(seq, region=region)
    if score is None:
        raise WebEvalUnavailable('T20 response not parseable')
    return score


def t20_csv(sample_fpath: str, region: int = 1,
            out_name: str = 'sample_t20_score.csv') -> str:
    """Reference T20_eval.main: per humanization row, score both chains and
    write ``sample_t20_score.csv`` next to the sample CSV
    (T20_eval.py:128-156)."""
    save_fpath = _beside(sample_fpath, out_name)
    if os.path.exists(save_fpath):
        return save_fpath
    _, human = _humanization_rows(sample_fpath)
    rows = []
    for line in human:
        try:
            h_score, h_type = get_t20_online(line['hseq'], region)
            l_score, l_type = get_t20_online(line['lseq'], region)
        except WebEvalUnavailable:
            continue
        rows.append([line['name'], h_score, h_type, l_score, l_type, line['hseq'],
                     line['lseq']])
    return _write_csv(save_fpath, ['Raw_name', 'h_score', 'h_gene', 'l_score', 'l_gene',
                                   'h_seq', 'l_seq'], rows)

def t20_frame_csv(sample_fpath: str,
                  out_name: str = 'sample_frame_t20_score.csv') -> str:
    """Reference T20_eval.frame_main: framework-only (region=2) heavy-chain
    scores, e.g. for nanobodies (T20_eval.py:104-125)."""
    save_fpath = _beside(sample_fpath, out_name)
    if os.path.exists(save_fpath):
        return save_fpath
    columns, human = _humanization_rows(sample_fpath)
    seq_col = 'hseq' if 'hseq' in columns else (
        'vhh_seq' if 'vhh_seq' in columns else columns[2])
    rows = []
    for line in human:
        seq = line[seq_col]
        try:
            score, chain_type = get_t20_online(seq, region=2)
        except WebEvalUnavailable:
            continue
        rows.append([line['name'], score, chain_type, seq])
    return _write_csv(save_fpath, ['Raw_name', 'h_score', 'h_gene', 'h_seq'], rows)

def t20_scores(seqs: List[Tuple[str, str]], region: int = 1,
               max_workers: int = 8) -> List[Optional[float]]:
    """Parallel T20 over (seq, chain) pairs; None where unavailable."""
    import concurrent.futures as futures
    out: List[Optional[float]] = [None] * len(seqs)
    with futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        futs = {ex.submit(t20_score, s, c, region): i
                for i, (s, c) in enumerate(seqs)}
        for fut in futures.as_completed(futs):
            i = futs[fut]
            try:
                out[i] = fut.result()
            except WebEvalUnavailable:
                out[i] = None
    return out


def t20_scores_from_csv(sample_csv: str, region: int = 1) -> Dict[str, float]:
    import numpy as np
    _, human = _humanization_rows(sample_csv)
    pairs = [(r['hseq'], 'H') for r in human] + [(r['lseq'], 'K') for r in human]
    scores = t20_scores(pairs, region=region)
    n = len(human)
    h = [s for s in scores[:n] if s is not None]
    l = [s for s in scores[n:] if s is not None]
    return {'t20_h_mean': float(np.mean(h)) if h else float('nan'),
            't20_l_mean': float(np.mean(l)) if l else float('nan')}

# ---------------------------------------------------------------------------
# SHAB Z-score (evaluation/Zscore_eval.py)
# ---------------------------------------------------------------------------

ZSCORE_URL = ('http://www.bioinf.org.uk/abs/shab/'
              'shab.cgi?aa_sequence={seq}&DB={chain_type}')
ZSCORE_REGEX = re.compile(
    r'<h3>The Z-score value of the Query sequence is: (-?[0-9.]+)</h3>')


def get_z_score_online(seq: str, retries: int = 5
                       ) -> Tuple[Optional[float], Optional[str]]:
    """(z, db) per Zscore_eval.py:19-39: DB keyed by chain type."""
    group = _chain_type(seq)
    chain_type = ('human_heavy' if group == 'H' else
                  'human_lambda' if group == 'L' else 'human_kappa')
    html = None
    url = ZSCORE_URL.format(seq=seq, chain_type=chain_type)
    last: Optional[Exception] = None
    for retry in range(retries):
        try:
            r = FETCH(url)
        except WebEvalUnavailable as e:
            last = e
            SLEEP(0.5 + retry * 5)
            continue
        SLEEP(0.5 + retry * 5)
        if r.ok:
            html = r.text
            break
    if html is None:
        raise WebEvalUnavailable(f'Z-score server is not accessible: {last}')
    matches = ZSCORE_REGEX.findall(html)
    if not matches:
        return None, None
    return float(matches[0]), chain_type


def z_score(seq: str) -> float:
    z, _ = get_z_score_online(seq)
    if z is None:
        raise WebEvalUnavailable('Z-score response not parseable')
    return z


def zscore_csv(sample_fpath: str,
               out_name: str = 'sample_z_score.csv') -> str:
    """Reference Zscore_eval.main output CSV (Zscore_eval.py:67-93)."""
    save_fpath = _beside(sample_fpath, out_name)
    _, human = _humanization_rows(sample_fpath)
    rows = []
    for line in human:
        try:
            h_z, h_type = get_z_score_online(line['hseq'])
            l_z, l_type = get_z_score_online(line['lseq'])
        except WebEvalUnavailable:
            continue
        rows.append([line['name'], h_z, h_type, l_z, l_type, line['hseq'], line['lseq']])
    return _write_csv(save_fpath, ['Raw_name', 'h_score', 'h_gene', 'l_score', 'l_gene',
                                   'h_seq', 'l_seq'], rows)

# ---------------------------------------------------------------------------
# Hu-mAb (evaluation/humab_eval.py)
# ---------------------------------------------------------------------------

HUMAB_URL = 'https://opig.stats.ox.ac.uk/webapps/sabdab-sabpred/sabpred/humab'
HUMAB_WAIT_SECONDS = 15.0


class _TableParser(HTMLParser):
    """Extract rows of <table class='table table-results'> without bs4."""

    def __init__(self):
        super().__init__()
        self.tables: List[List[List[str]]] = []
        self._in_table = False
        self._in_cell = False
        self._row: List[str] = []
        self._cell: List[str] = []

    def handle_starttag(self, tag, attrs):
        if tag == 'table':
            classes = dict(attrs).get('class', '')
            if 'table-results' in classes:
                self._in_table = True
                self.tables.append([])
        elif self._in_table and tag == 'tr':
            self._row = []
        elif self._in_table and tag in ('td', 'th'):
            self._in_cell = True
            self._cell = []

    def handle_endtag(self, tag):
        if tag == 'table' and self._in_table:
            self._in_table = False
        elif self._in_table and tag == 'tr':
            if self._row:
                self.tables[-1].append(self._row)
        elif self._in_table and tag in ('td', 'th'):
            self._in_cell = False
            self._row.append(''.join(self._cell).strip())

    def handle_data(self, data):
        if self._in_cell:
            self._cell.append(data)


def extract_human_rows(html: str) -> List[List[str]]:
    """The 'HUMAN' row of each of the first two result tables
    (humab_eval.py:13-36: only the first two of three tables are used)."""
    parser = _TableParser()
    parser.feed(html)
    extracted = []
    for table in parser.tables[:2]:
        human_row = [None, None, None, None]
        for row in table:
            if row and row[-1] == 'HUMAN':
                human_row = row
        extracted.append(human_row)
    return extracted


def get_humab_result(job_name: str, h_seq: str, l_seq: str,
                     wait: Optional[float] = None) -> List:
    """POST the scoring job, wait, fetch the redirected result page, and
    return the flattened HUMAN rows + sequences (humab_eval.py:40-73)."""
    data = {
        'h_sequence_score': h_seq,
        'l_sequence_score': l_seq,
        'jobname_score': job_name,
        'humanise': True,
    }
    response = FETCH(HUMAB_URL, method='post', data=data)
    result_url = response.url

    SLEEP(HUMAB_WAIT_SECONDS if wait is None else wait)

    result = FETCH(result_url)
    if result.status_code != 200:
        raise WebEvalUnavailable(
            'Hu-mAb result page not ready (need a larger wait?)')
    rows = extract_human_rows(result.text)
    extract_data: List = []
    for row in rows:
        extract_data.extend(row)
    return extract_data + [h_seq, l_seq]


def humab_scores(h_seq: str, l_seq: str, job_name: str = 'hudiff_job'
                 ) -> Dict[str, object]:
    """Keyed Hu-mAb classifier outputs for one pair."""
    data = get_humab_result(job_name, h_seq, l_seq)
    keys = ['h_v_gene', 'h_score', 'h_threshold', 'h_classification',
            'l_v_gene', 'l_score', 'l_threshold', 'l_classification']
    out: Dict[str, object] = dict(zip(keys, data[:8]))
    if out.get('h_score') is None and out.get('l_score') is None:
        raise WebEvalUnavailable('Hu-mAb response not parseable')
    for k in ('h_score', 'l_score', 'h_threshold', 'l_threshold'):
        try:
            out[k] = float(out[k])  # type: ignore[arg-type]
        except (TypeError, ValueError):
            pass
    return out


def humab_csv(sample_fpath: str,
              out_name: str = 'sample_humab_score.csv') -> str:
    """Reference humab_eval.main output CSV (humab_eval.py:104-128)."""
    save_fpath = _beside(sample_fpath, out_name)
    _, human = _humanization_rows(sample_fpath)
    rows = []
    for i, line in enumerate(human):
        l_chain_type = _chain_type(line['lseq'])
        job_name = f'{line["Specific"]}_{i}'
        try:
            data = get_humab_result(job_name, line['hseq'], line['lseq'])
        except WebEvalUnavailable:
            continue
        rows.append([line['name']] + data + [l_chain_type])
    return _write_csv(save_fpath, [
        'Raw_name', 'h_v_gene', 'h_score', 'h_threshold', 'h_classification',
        'l_v_gene', 'l_score', 'l_threshold', 'l_classification',
        'h_seq', 'l_seq', 'l_chain_type'], rows)

# ---------------------------------------------------------------------------
# ABLSTM (local model; evaluation/ABLSTM_eval.py)
# ---------------------------------------------------------------------------

def ablstm_scores(aho_seqs: List[str], model_path: Optional[str] = None
                  ) -> List[float]:
    """Local ABLSTM humanness over AHo-aligned sequences
    (evaluation/ABLSTM_eval.py:17-84). Requires the external `ablstm`
    package + weights; raises WebEvalUnavailable otherwise."""
    try:
        from ablstm import ModelLSTM  # type: ignore
    except ImportError as e:
        raise WebEvalUnavailable('ablstm package not installed') from e
    model = ModelLSTM(embedding_dim=64, hidden_dim=64, device='cpu',
                      gapped=True)
    if model_path:
        model.load(fn=model_path)
    import tempfile
    with tempfile.NamedTemporaryFile('w', suffix='.fa', delete=False) as f:
        for i, s in enumerate(aho_seqs):
            f.write(f'>{i}\n{s}\n')
        path = f.name
    scores = model.eval(fn=path)
    return [float(s) for s in scores]
