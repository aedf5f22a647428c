"""OAS dataset preprocessing, datasets and host-side batch assembly.

Counterpart of hudiff_tpu/data/oas.py (the reference's dataset/
preprocess.py:27-175, oas_pair_dataset_new.py:129-278 and
oas_unpair_dataset_new.py:72-184) over the port's RecordStore
(data/store.py), with the same record layout, splits and batches.

Input formats:
- paired OAS ``.csv.gz`` exports with embedded ANARCI numbering JSON columns
  (``ANARCI_numbering_heavy`` / ``..._light``); the first line is metadata,
  the second the header;
- unpaired pickled record lists (name, seq, pad_seq, chain, aho_seq, ...);
- raw sequence CSVs (``build_pair_dataset_from_csv``,
  ``build_vhh_dataset_from_csv``).

The JAX package reads CSVs with pandas; this module reads the same files
with the standard library's ``gzip`` and ``csv``. Each cell is kept as its
text, an empty cell reads as pandas' NaN would print (``'nan'``) where a
cell becomes a string, and rows with fewer cells than the header are
filled with empty cells, as pandas fills them with NaN. (pandas would read
a name column of numbers as numbers: ``007`` is its ``7`` and this
module's ``007``.)

Usage (prebuild a store):
  python -m hudiff_tpu_torch.data.oas pair-from-csv --csv pairs.csv --out DIR
  python -m hudiff_tpu_torch.data.oas heavy --data heavy.pkl
"""
from __future__ import annotations

import csv
import gzip
import io
import json
import logging
import os
import pickle
import random
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .. import constants as C
from ..tokenizer import Tokenizer, aho_onehot
from . import store as rs

log = logging.getLogger(__name__)


def _read_csv_rows(f: io.TextIOBase, header_row: int = 0) -> Tuple[List[str], List[dict]]:
    """(columns, rows as {column: text}) of CSV text, the header at parsed
    row ``header_row`` (the rows before it are skipped, as pandas'
    ``header=``); blank lines are skipped, short rows filled with ''."""
    rows = [r for r in csv.reader(f) if r]
    header = rows[header_row]
    out = []
    for r in rows[header_row + 1:]:
        r = r + [''] * (len(header) - len(r))
        out.append(dict(zip(header, r)))
    return header, out


def _text(cell: str) -> str:
    """A cell as pandas' ``str(value)`` gives it for a text column."""
    return cell if cell != '' else 'nan'


def place_in_grid(numbering: Dict[str, str], heavy: bool) -> Optional[str]:
    """Scatter {IMGT label -> residue} into the fixed grid; '-' elsewhere.

    Returns None if any label falls outside the grid (the reference drops
    such rows, preprocess.py:96-98)."""
    pos_dict = C.HEAVY_POSITIONS_IDX if heavy else C.LIGHT_POSITIONS_IDX
    length = C.HEAVY_LEN if heavy else C.LIGHT_LEN
    grid = ['-'] * length
    for key, value in numbering.items():
        idx = pos_dict.get(key.strip())
        if idx is None:
            return None
        grid[idx] = value
    return ''.join(grid)


def _parse_anarci_json(raw: str) -> Dict[str, Dict[str, str]]:
    return json.loads(raw.replace("'", '"'))


def _parse_pair_row(row: dict, mouse: bool, is_VHH: bool):
    """(h_seq, l_seq, h_pad, l_pad, aho_h, aho_l) of one OAS row, or None
    where the reference drops the row (unreadable numbering, sequences that
    are not in the alignment, 'X' residues, unplaceable labels, a failed
    AHo alignment in mouse mode)."""
    locus_h, locus_l = row.get('locus_heavy', ''), row.get('locus_light', '')
    h_segs = _parse_anarci_json(row['ANARCI_numbering_heavy'])
    l_segs = _parse_anarci_json(row['ANARCI_numbering_light'])
    h_seq = ''.join(''.join(h_segs[s].values()) for s in C.SEG_NAMES[locus_h])
    l_seq = ''.join(''.join(l_segs[s].values()) for s in C.SEG_NAMES[locus_l])
    if (h_seq not in row['sequence_alignment_aa_heavy']
            or l_seq not in row['sequence_alignment_aa_light']):
        return None
    if 'X' in h_seq or 'X' in l_seq:
        return None
    h_pad = place_in_grid({k.strip(): v for d in h_segs.values() for k, v in d.items()},
                          heavy=True)
    l_pad = place_in_grid({k.strip(): v for d in l_segs.values() for k, v in d.items()},
                          heavy=False)
    if h_pad is None or l_pad is None:
        return None
    aho_h = aho_l = None
    if mouse:
        from ..numbering import aho as aho_numbering
        aho_h = aho_numbering.align_aho(h_seq, is_VHH=is_VHH)
        aho_l = aho_numbering.align_aho(l_seq, chain=locus_l)
        if aho_h is None or aho_l is None:
            return None
    return h_seq, l_seq, h_pad, l_pad, aho_h, aho_l


def parse_cgz_file(path: str, chn_set: set, mouse: bool = False,
                   is_VHH: bool = False, verbose: bool = False
                   ) -> Tuple[List[tuple], set]:
    """Parse one paired OAS .csv.gz into grid-padded records.

    As the reference's preprocess.parse_cgz_file: rows with a light heavy
    locus or a heavy light locus, 'X' residues, unplaceable labels, or a
    duplicate (H, L) pair (``chn_set`` holds the pairs seen, across files)
    are dropped. ``mouse=True`` also aligns both chains to AHo. A truncated
    gzip file gives no records."""
    try:
        with gzip.open(path, 'rt', newline='') as f:
            _, rows = _read_csv_rows(f, header_row=1)
    except EOFError:
        log.warning('corrupted GZ-compressed CSV file: %s', path)
        return [], chn_set

    name = os.path.basename(path).replace('.csv.gz', '')
    out = []
    for row in rows:
        if row.get('locus_heavy') in ('L', 'K') or row.get('locus_light') == 'H':
            continue
        try:
            parsed = _parse_pair_row(row, mouse, is_VHH)
        except (KeyError, ValueError, AttributeError, TypeError):
            continue   # unreadable numbering or an unknown locus
        if parsed is None:
            continue
        h_seq, l_seq, h_pad, l_pad, aho_h, aho_l = parsed
        if (h_seq, l_seq) in chn_set:
            continue
        chn_set.add((h_seq, l_seq))
        out.append((name, h_seq, l_seq, h_pad, l_pad, aho_h, aho_l,
                    row['locus_heavy'], row['locus_light']))
    return out, chn_set


def _write_split(index_path: str, n: int, split_ratio: float, seed: int) -> None:
    """The persisted train/val split: ids shuffled by ``RandomState(seed)``,
    the first ``int(n * split_ratio)`` for training."""
    ids = np.arange(n)
    np.random.RandomState(seed).shuffle(ids)
    split = int(n * split_ratio)
    os.makedirs(os.path.dirname(index_path) or '.', exist_ok=True)
    np.savez(index_path, train=ids[:split], val=ids[split:])


class OasPairDataset:
    """Paired H/L dataset on a RecordStore, with a persisted train/val split
    (reference OasPairDataset, oas_pair_dataset_new.py:129-278). The store
    is built from ``<raw_path>/new_cgz_data/*.csv.gz`` the first time."""

    def __init__(self, raw_path: str, mouse: bool = False, version: str = 'tmp',
                 split_ratio: float = 0.95, seed: int = 2023):
        self.raw_path = raw_path.rstrip('/')
        self.cgz_path = os.path.join(self.raw_path, 'new_cgz_data')
        proc_dir = os.path.join(self.raw_path, 'processed')
        self.store_path = os.path.join(proc_dir, f'oas_pair_{version}')
        self.index_path = os.path.join(proc_dir, f'oas_pair_index_{version}.npz')
        self.mouse = mouse
        self.split_ratio = split_ratio
        self.seed = seed
        if not rs.exists(self.store_path):
            self._process()
        self.store = rs.RecordStore(self.store_path)
        if not os.path.exists(self.index_path):
            _write_split(self.index_path, len(self.store), split_ratio, seed)
        idx = np.load(self.index_path)
        self.splits = {'train': idx['train'], 'val': idx['val']}

    def _process(self) -> None:
        chn_set: set = set()
        records = []
        for fname in sorted(os.listdir(self.cgz_path)):
            fpath = os.path.join(self.cgz_path, fname)
            if os.path.isdir(fpath):
                continue
            recs, chn_set = parse_cgz_file(fpath, chn_set, mouse=self.mouse)
            records.extend(recs)
        with rs.RecordStoreWriter(self.store_path) as w:
            for (name, h_seq, l_seq, h_pad, l_pad, aho_h, aho_l,
                 h_type, l_type) in records:
                w.put_obj({
                    'name': name, 'h_seq': h_seq, 'l_seq': l_seq,
                    'h_pad_seq': h_pad, 'l_pad_seq': l_pad,
                    'aho_h_pad_seq': aho_h, 'aho_l_pad_seq': aho_l,
                    'h_type': h_type, 'l_type': l_type,
                })
        _write_split(self.index_path, len(records), self.split_ratio, self.seed)

    def __len__(self) -> int:
        return len(self.store)

    def __getitem__(self, idx: int) -> dict:
        return self.store[int(idx)]


def build_pair_dataset_from_csv(csv_path: str, out_dir: str,
                                h_column: str = 'h_seq',
                                l_column: str = 'l_seq',
                                name_column: str = 'name',
                                type_filter: Optional[str] = None,
                                version: str = 'tmp',
                                split_ratio: float = 0.95,
                                seed: int = 2023) -> str:
    """Build a paired training store from a raw H/L sequence CSV (columns
    name, h_seq, l_seq; e.g. the HuAb348 CSVs), numbering both chains with
    the numbering layer (IMGT grid and AHo alignment).

    ``type_filter`` keeps only rows whose 'type' column matches (e.g.
    'humanized'). Both chains must clear the fragment floor and type as
    their column's group (the heavy one as 'H' outright); duplicate (H, L)
    pairs are dropped. Writes the RecordStore and split index in the layout
    ``OasPairDataset`` reads and returns ``out_dir`` (``OasPairDataset(
    out_dir, version=...)``, or ``pretrain --data out_dir``)."""
    from ..numbering import align as AL
    from ..numbering import imgt as imgt_numbering

    with open(csv_path, newline='') as f:
        columns, rows = _read_csv_rows(f)
    n_rows = len(rows)
    if type_filter is not None:
        if 'type' not in columns:
            raise ValueError(
                f"--type-filter given but {csv_path} has no 'type' column "
                f'(columns: {columns})')
        rows = [r for r in rows if r['type'] == type_filter]
        n_rows = len(rows)
    proc_dir = os.path.join(out_dir, 'processed')
    store_path = os.path.join(proc_dir, f'oas_pair_{version}')
    index_path = os.path.join(proc_dir, f'oas_pair_index_{version}.npz')
    os.makedirs(proc_dir, exist_ok=True)
    n_written = 0
    seen: set = set()
    with rs.RecordStoreWriter(store_path) as w:
        for i, r in enumerate(rows):
            h_seq, l_seq = _text(r[h_column]), _text(r[l_column])
            if (h_seq, l_seq) in seen:
                continue
            seen.add((h_seq, l_seq))
            try:
                h_group, _, h_score = AL.detect_chain_type(h_seq)
                l_scores = AL.profile_scores(l_seq)
                _, _, l_score = AL.detect_chain_type(l_seq, l_scores)
                l_group, l_margin = AL.classify_light(l_seq, l_scores)
            except (ValueError, TypeError):
                log.warning('row %d: chain unalignable; skipped', i)
                continue
            if (h_score < AL.MIN_CHAIN_SCORE or l_score < AL.MIN_CHAIN_SCORE
                    or h_group != 'H' or AL.is_confident_heavy(l_scores)):
                reason = ('l column types as a heavy chain (swapped '
                          'columns?)' if AL.is_confident_heavy(l_scores)
                          else f'h: {h_group} {h_score:.0f}, l: {l_score:.0f}')
                log.warning('row %d: failed chain typing (%s); skipped', i, reason)
                continue
            msg = AL.ambiguous_light_message(l_group, l_margin)
            if msg is not None:
                log.warning('row %d: %s', i, msg)
            h = imgt_numbering.grid_string(h_seq, heavy=True, chain_hint='H')
            l = imgt_numbering.grid_string(l_seq, heavy=False, chain_hint=l_group)
            if h is None or l is None:
                log.warning('row %d unalignable; skipped', i)
                continue
            w.put_obj({
                'name': _text(r[name_column]) if name_column in r else f'pair_{i}',
                'h_seq': h_seq, 'l_seq': l_seq,
                'h_pad_seq': h['grid'], 'l_pad_seq': l['grid'],
                'aho_h_pad_seq': h['aho'], 'aho_l_pad_seq': l['aho'],
                'h_type': 'H', 'l_type': l_group,
            })
            n_written += 1
    _write_split(index_path, n_written, split_ratio, seed)
    log.info('wrote %d/%d pair records to %s', n_written, n_rows, store_path)
    return out_dir


def build_vhh_dataset_from_csv(csv_path: str, out_dir: str,
                               seq_column: Optional[str] = None,
                               is_VHH: bool = True) -> str:
    """Build a VHH fine-tuning dataset pickle from a raw sequence CSV (e.g.
    abnativ_select_vhh.csv) with the numbering layer (IMGT grid and AHo
    alignment). The sequence column is ``seq_column``, else 'vhhseq',
    'vhh_seq' or the last column. Returns the pickle path (for
    ``OasUnpairDataset(chaintype='vhh')``)."""
    from ..numbering import aho as aho_numbering
    from ..numbering import imgt as imgt_numbering

    with open(csv_path, newline='') as f:
        columns, rows = _read_csv_rows(f)
    col = seq_column or ('vhhseq' if 'vhhseq' in columns else
                         'vhh_seq' if 'vhh_seq' in columns else columns[-1])
    lines = []
    for i, r in enumerate(rows):
        seq = r[col]
        placed = imgt_numbering.grid_string(seq, heavy=True,
                                            chain_hint='VHH' if is_VHH else 'H')
        aho_seq = aho_numbering.align_aho(seq, is_VHH=is_VHH)
        if placed is None or aho_seq is None:
            log.warning('row %d unalignable; skipped', i)
            continue
        lines.append((f'vhh_{i}', seq, placed['grid'], 'H', aho_seq))
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, 'vhh_dataset.pkl')
    with open(out_path, 'wb') as f:
        pickle.dump(lines, f)
    log.info('wrote %d/%d VHH records to %s', len(lines), len(rows), out_path)
    return out_path


class OasUnpairDataset:
    """Unpaired heavy/VHH dataset (reference OasUnPairDataset,
    oas_unpair_dataset_new.py:72-184). Source: a pickled list of tuples
    (name, seq, pad_seq, chain, aho_seq, ...), turned into a store beside
    it the first time."""

    def __init__(self, data_path: str, chaintype: str = 'heavy',
                 split_ratio: float = 0.95, seed: int = 2023):
        root = os.path.dirname(data_path)
        self.store_path = os.path.join(root, f'oas_{chaintype}')
        self.index_path = os.path.join(root, f'oas_{chaintype}_idx.npz')
        self.split_ratio = split_ratio
        self.seed = seed
        if not rs.exists(self.store_path):
            self._process(data_path)
        self.store = rs.RecordStore(self.store_path)
        if not os.path.exists(self.index_path):
            _write_split(self.index_path, len(self.store), split_ratio, seed)
        idx = np.load(self.index_path)
        self.splits = {'train': idx['train'], 'val': idx['val']}

    def _process(self, data_path: str) -> None:
        with open(data_path, 'rb') as f:
            lines = pickle.load(f)
        with rs.RecordStoreWriter(self.store_path) as w:
            for line in lines:
                name, seq, pad_seq, chain, aho_seq = line[:5]
                w.put_obj({'name': name, 'seq': seq, 'pad_seq': pad_seq,
                           'chain': chain, 'aho_seq': aho_seq})
        _write_split(self.index_path, len(lines), self.split_ratio, self.seed)

    def __len__(self) -> int:
        return len(self.store)

    def __getitem__(self, idx: int) -> dict:
        return self.store[int(idx)]


# ---------------------------------------------------------------------------
# Batch assembly (host side; copied from hudiff_tpu/data/oas.py:369-442):
# token grids and chain types; the OA-ARDM corruption runs on the device
# (ops/masking.py).
# ---------------------------------------------------------------------------

def pair_batch(records: Sequence[dict], tokenizer: Optional[Tokenizer] = None,
               with_aho: bool = False) -> Dict[str, np.ndarray]:
    tok = tokenizer or Tokenizer()
    B = len(records)
    tokens = np.empty((B, C.PAIR_LEN), np.int32)
    chain = np.empty((B, 2), np.int32)
    for i, r in enumerate(records):
        tokens[i, : C.HEAVY_LEN] = tok.seq2idx(r['h_pad_seq'])
        tokens[i, C.HEAVY_LEN:] = tok.seq2idx(r['l_pad_seq'])
        chain[i, 0] = tok.chain_type_idx(r['h_type'])
        chain[i, 1] = tok.chain_type_idx(r['l_type'])
    out = {'tokens': tokens, 'chain_type': chain}
    if with_aho:
        out['aho_h'] = np.stack([aho_onehot(r['aho_h_pad_seq']) for r in records])
        out['aho_l'] = np.stack([aho_onehot(r['aho_l_pad_seq']) for r in records])
    return out


def heavy_batch(records: Sequence[dict], tokenizer: Optional[Tokenizer] = None,
                with_aho: bool = False, drop_aho_failed: bool = False
                ) -> Dict[str, np.ndarray]:
    """Heavy/VHH batch. ``drop_aho_failed`` drops the rows whose AHo
    alignment ends in '---', as the camel collater does
    (oas_unpair_dataset_new.py:305)."""
    tok = tokenizer or Tokenizer()
    if drop_aho_failed:
        records = [r for r in records if not r['aho_seq'].endswith('---')]
    B = len(records)
    tokens = np.empty((B, C.HEAVY_LEN), np.int32)
    for i, r in enumerate(records):
        tokens[i] = tok.seq2idx(r['pad_seq'])
    out = {'tokens': tokens}
    if with_aho:
        out['aho'] = np.stack([aho_onehot(r['aho_seq']) for r in records])
    return out


def n_batches_per_epoch(n_items: int, batch_size: int, drop_last: bool = True) -> int:
    """Number of batches one epoch of ``batch_iterator`` yields for a split
    of ``n_items`` (full-split validation passes pull that many)."""
    if n_items <= 0:
        raise ValueError('empty dataset split')
    if drop_last and n_items >= batch_size:
        return n_items // batch_size
    return -(-n_items // batch_size)


def batch_iterator(dataset, split_ids: np.ndarray, batch_size: int,
                   collate, seed: int = 0, drop_last: bool = True,
                   shuffle: bool = True) -> Iterable[Dict[str, np.ndarray]]:
    """Infinite epoch-shuffled batch iterator over a dataset split
    (``random.Random(seed)`` shuffles the ids each epoch). When the split
    is smaller than ``batch_size`` the whole split is yielded each epoch."""
    rng = random.Random(seed)
    ids = list(map(int, split_ids))
    if not ids:
        raise ValueError('empty dataset split')
    effective_drop_last = drop_last and len(ids) >= batch_size
    while True:
        if shuffle:
            rng.shuffle(ids)
        stop = (len(ids) - batch_size + 1) if effective_drop_last else len(ids)
        for s in range(0, stop, batch_size):
            yield collate([dataset[i] for i in ids[s:s + batch_size]])


def main(argv=None):
    """Pre-build record stores: ``pair`` from an OAS download directory
    (raw_path/new_cgz_data/*.csv.gz), ``heavy``/``vhh`` from a pickled list,
    ``vhh-from-csv`` from a raw sequence CSV, ``pair-from-csv`` from a raw
    name,h_seq,l_seq CSV."""
    import argparse
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=main.__doc__)
    sub = p.add_subparsers(dest='cmd', required=True)

    q = sub.add_parser('pair', help='paired H/L store from an OAS csv.gz dir')
    q.add_argument('--raw-path', required=True)
    q.add_argument('--mouse', action='store_true')
    q.add_argument('--version', default='tmp')

    q = sub.add_parser('heavy', help='unpaired heavy store from a pickle')
    q.add_argument('--data', required=True)
    q = sub.add_parser('vhh', help='VHH store from a pickle')
    q.add_argument('--data', required=True)

    q = sub.add_parser('vhh-from-csv', help='VHH pickle + store from a raw sequence CSV')
    q.add_argument('--csv', required=True)
    q.add_argument('--out', required=True)
    q.add_argument('--seq-column', default=None)

    q = sub.add_parser('pair-from-csv',
                       help='paired store from a raw name,h_seq,l_seq CSV')
    q.add_argument('--csv', required=True)
    q.add_argument('--out', required=True)
    q.add_argument('--type-filter', default=None,
                   help="keep only rows whose 'type' column matches")
    q.add_argument('--version', default='tmp',
                   help="store version tag; 'tmp' (default) is what "
                        "`pretrain --data <out>` reads")

    args = p.parse_args(argv)
    if args.cmd == 'pair':
        ds = OasPairDataset(args.raw_path, mouse=args.mouse, version=args.version)
    elif args.cmd in ('heavy', 'vhh'):
        ds = OasUnpairDataset(args.data, chaintype=args.cmd)
    elif args.cmd == 'pair-from-csv':
        out = build_pair_dataset_from_csv(args.csv, args.out, type_filter=args.type_filter,
                                          version=args.version)
        ds = OasPairDataset(out, version=args.version)
    else:
        pkl = build_vhh_dataset_from_csv(args.csv, args.out, seq_column=args.seq_column)
        ds = OasUnpairDataset(pkl, chaintype='vhh')
    print(f'store ready: {ds.store_path} ({len(ds)} records; '
          f'train={len(ds.splits["train"])}, val={len(ds.splits["val"])})')
    return ds.store_path


if __name__ == '__main__':
    main()
