# Copied from hudiff_tpu/tokenizer.py.
"""Amino-acid tokenizer.

API-compatible with the reference tokenizer (utils/tokenizer.py:43-149) but
numpy-native: token-id vectors are ``np.ndarray``; callers move them to a
device themselves.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from . import constants as C


class Tokenizer:
    """23-token amino-acid vocabulary: 20 AAs + 'X' + pad '-' + '<msk>'."""

    def __init__(self) -> None:
        self.toks: List[str] = list(C.TOKENS)
        self.tok2idx_dict = {tok: idx for idx, tok in enumerate(self.toks)}
        self.tok_pad = C.TOK_PAD
        self.tok_msk = C.TOK_MSK
        self.idx_pad = C.IDX_PAD
        self.idx_msk = C.IDX_MSK

    @property
    def n_toks(self) -> int:
        return len(self.toks)

    def tok2idx(self, tok: str) -> int:
        return self.tok2idx_dict[tok]

    def seq2idx(self, aa_seq: Iterable[str]) -> np.ndarray:
        """Sequence (string or list of tokens) -> int32 token-id vector."""
        return np.asarray([self.tok2idx_dict[t] for t in aa_seq], dtype=np.int32)

    def seq2idx_batch(self, aa_seq_list: Sequence[Iterable[str]]) -> np.ndarray:
        """Batch of sequences -> [B, max_len] id matrix, padded with idx_pad."""
        rows = [self.seq2idx(s) for s in aa_seq_list]
        max_len = max(len(r) for r in rows)
        out = np.full((len(rows), max_len), self.idx_pad, dtype=np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    def idx2seq(self, idx_vec) -> str:
        """Token ids -> string, dropping pad tokens."""
        return ''.join(self.toks[int(i)] for i in np.asarray(idx_vec).ravel()
                       if int(i) != self.idx_pad)

    def idx2seq_pad(self, idx_vec) -> str:
        """Token ids -> string, keeping pad tokens as '-'."""
        return ''.join(self.toks[int(i)] for i in np.asarray(idx_vec).ravel())

    def idx2seq_batch(self, idx_mat) -> List[str]:
        return [self.idx2seq(row) for row in np.asarray(idx_mat)]

    def idx2seq_pad_batch(self, idx_mat) -> List[str]:
        return [self.idx2seq_pad(row) for row in np.asarray(idx_mat)]

    @staticmethod
    def chain_type_idx(chain: str) -> int:
        try:
            return C.CHAIN_TYPES[chain]
        except KeyError:
            raise TypeError(f'Unknown chain type: {chain!r}')


def aho_onehot(seq: str, dtype=np.float32) -> np.ndarray:
    """One-hot encode an AHo-aligned sequence over the 21-letter AbNatiV
    alphabet (20 AAs + gap). Unknown letters (e.g. 'X') one-hot to all-zeros,
    matching the reference's pandas.get_dummies behaviour
    (model/nanoencoder/abnativ_onehot.py:56-119 with is_masking=False).
    """
    lut = {a: i for i, a in enumerate(C.ABNATIV_ALPHABET)}
    out = np.zeros((len(seq), C.ABNATIV_ALPHABET_SIZE), dtype=dtype)
    for i, ch in enumerate(seq):
        j = lut.get(ch)
        if j is not None:
            out[i, j] = 1.0
    return out


def aho_onehot_batch(seqs: Sequence[str], dtype=np.float32) -> np.ndarray:
    return np.stack([aho_onehot(s, dtype=dtype) for s in seqs], axis=0)


def bert_masked_onehot(seq: str, perc_masked: float, rng: np.random.RandomState,
                       dtype=np.float32):
    """BERT-style 80/10/10 masking on the AHo one-hot (reference
    torch_masking_BERT_onehot with is_masking=True,
    model/nanoencoder/abnativ_onehot.py:56-119): masked positions become the
    uniform vector [1/21]*21, 10% are replaced by a random residue, 10% kept.

    Returns (clean_onehot, masked_onehot). Used when training AbNatiV-style
    scorers; the runtime scoring path uses plain aho_onehot.
    """
    clean = aho_onehot(seq, dtype=dtype)
    masked = clean.copy()
    n = len(seq)
    n_masking = int(np.floor(n * perc_masked))
    n_mask = int(np.floor(n_masking * 0.8))
    n_replace = int(np.floor(n_masking * 0.1))
    if n_mask:
        ids = rng.permutation(n)[: n_mask + n_replace]
        V = C.ABNATIV_ALPHABET_SIZE
        masked[ids[:n_mask]] = 1.0 / V
        repl = rng.randint(0, V, n_replace)
        masked[ids[n_mask:]] = np.eye(V, dtype=dtype)[repl]
    return clean, masked
