"""Humanization on the card: paired antibodies (HuDiff-Ab) and nanobodies
(HuDiff-Nb).

Counterpart of hudiff_tpu/sampling/humanize.py (the ``ab`` and ``nano``
paths: host prep ``pair_input`` / ``pair_inpaint_input`` / ``nano_input``,
packed batching, ``PairHumanizer`` / ``NanoHumanizer`` with k > 1 sampling,
the CLI and its model-free ``graft`` baseline). The host helpers are
copied, the device work is the port's sampler and denoiser. Entry points
run on ``cuda`` unless the caller passes ``device='cpu'``; without a card
they raise rather than fall back.

Usage:
  python -m hudiff_tpu_torch.sampling.humanize ab --ckpt CKPT.pt \
      --data-fpath humanization_pair_data_filter.csv --batch-size 64
  python -m hudiff_tpu_torch.sampling.humanize ab --ckpt CKPT.pt --hseq ... --lseq ... \
      [--sample-method inpaint] [--positions-per-step 2]
  python -m hudiff_tpu_torch.sampling.humanize nano --ckpt NB.pt --vhh-seq ... \
      [--sample-method inpaint]
  python -m hudiff_tpu_torch.sampling.humanize graft --hseq ... --lseq ... \
      [--back-mutation] [--output OUT.csv]
"""
from __future__ import annotations

import argparse
import csv
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import constants as C
from ..models.denoiser import DenoiserConfig
from ..numbering import align as AL
from ..numbering import imgt as IMGT
from ..tokenizer import Tokenizer
from ..training import checkpoints as CKPT
from ..training.logger import get_logger, get_new_log_dir, seed_all
from ..utils.device import resolve_device
from . import sampler as S

_TOK = Tokenizer()


# ---------------------------------------------------------------------------
# Input construction (copied from hudiff_tpu/sampling/humanize.py:50-99)
# ---------------------------------------------------------------------------

def pair_input(h_seq: str, l_seq: str, finetune: bool = False
               ) -> Optional[Dict[str, np.ndarray]]:
    """Build the 291-grid input for one antibody
    (reference batch_input_element, sample.py:142-179)."""
    # reject fragments / non-antibody chains the way ANARCI numbering
    # failure would in the reference (scores: real domains ~500, junk <10)
    try:
        h_scores = AL.profile_scores(h_seq)
        _, _, h_score = AL.detect_chain_type(h_seq, h_scores)
        l_scores = AL.profile_scores(l_seq)
        _, _, l_score = AL.detect_chain_type(l_seq, l_scores)
        # kappa/lambda by direct K-vs-L profile comparison
        l_group, l_margin = AL.classify_light(l_seq, l_scores)
    except (ValueError, TypeError):
        return None  # unalignable / non-string input (NaN CSV cells etc.)
    if h_score < AL.MIN_CHAIN_SCORE or l_score < AL.MIN_CHAIN_SCORE:
        return None
    if AL.is_confident_heavy(l_scores) or AL.is_confident_light(h_scores):
        return None  # a true heavy chain in the light slot or the reverse
    AL.warn_ambiguous_light(l_group, l_margin)
    h = IMGT.grid_string(h_seq, heavy=True, chain_hint='H')
    l = IMGT.grid_string(l_seq, heavy=False, chain_hint=l_group)
    if h is None or l is None:
        return None

    tokens = np.concatenate([_TOK.seq2idx(h['grid']), _TOK.seq2idx(l['grid'])])
    region = np.concatenate([C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX])
    chain = np.asarray([C.CHAIN_TYPES['H'], C.CHAIN_TYPES[l_group]], np.int32)

    if finetune:
        cdr = np.concatenate([C.HEAVY_CDR_KABAT_NO_VERNIER,
                              C.LIGHT_CDR_KABAT_NO_VERNIER])
        mask = (cdr == 0) & (tokens != C.IDX_PAD)
    else:
        cdr = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX])
        mask = cdr == 0
    positions = np.nonzero(mask)[0].astype(np.int32)
    src = tokens.copy()
    src[mask] = C.IDX_MSK
    # pad_to: per-mode upper bound on masked slots
    return {'tokens': src, 'clean': tokens, 'region': region, 'chain': chain,
            'positions': positions, 'pad_to': int(np.count_nonzero(cdr == 0)),
            'aho_h': h['aho'], 'aho_l': l['aho'],
            'h_grid': h['grid'], 'l_grid': l['grid'], 'l_group': l_group}


# Copied from hudiff_tpu/sampling/humanize.py:102-163.
def pair_inpaint_input(h_seq: str, l_seq: str
                       ) -> Optional[Dict[str, np.ndarray]]:
    """Germline-graft inpainting init (reference batch_inpaint_input_element,
    sample.py:286-310): graft the parental CDRs onto the nearest human
    germline (numbering/germline.py), freeze the framework slots where the
    parental residue already equals the germline, and resample every other
    framework slot. Falls back to the chain-type consensus as the template
    when the germline graft is unavailable for a chain.

    Reuses the grids pair_input already aligned: no second alignment pass.
    """
    from ..numbering import consensus as CONS
    from ..numbering import germline as G
    base = pair_input(h_seq, l_seq, finetune=False)
    if base is None:
        return None
    h_grid = np.asarray(list(base['h_grid']))
    l_grid = np.asarray(list(base['l_grid']))
    l_group = base['l_group']

    def consensus_identity_slots(grid: np.ndarray, aho: str,
                                 profile: str) -> np.ndarray:
        """Fallback template: grid slots where the parental residue equals
        the chain-type consensus at the same AHo column (both AHo-aligned,
        so columns correspond; the k-th residue of the AHo alignment
        occupies the k-th occupied grid slot)."""
        par_aho = np.asarray(list(aho))
        cons_arr = np.asarray(list(CONS.CONSENSUS[profile][0]))
        identity_aho = par_aho == cons_arr
        occ_slots = np.nonzero(grid != '-')[0]
        res_cols = np.nonzero(par_aho != '-')[0]
        n = min(len(occ_slots), len(res_cols))
        ident_grid = np.zeros(len(grid), bool)
        ident_grid[occ_slots[:n]] = identity_aho[res_cols[:n]]
        return ident_grid

    def identity_slots(grid: np.ndarray, aho: str, group: str,
                       profile: str) -> np.ndarray:
        """Frozen slots: parental residue equals its germline graft
        (reference graft_chain identity_pos_list, sample.py:217-226)."""
        try:
            g = G.graft_cdrs(grid, group)['grid']
        except ValueError:
            return consensus_identity_slots(grid, aho, profile)
        return (grid == g) & (grid != '-')

    identity = np.concatenate([
        identity_slots(h_grid, base['aho_h'], 'H', 'H'),
        identity_slots(l_grid, base['aho_l'], l_group, l_group)])

    cdr = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX])
    # resample every framework slot not frozen by template identity,
    # including unoccupied insertion slots, exactly like the reference mask
    # (h_l_mask = CDR_INDEX==0 & init==pad, sample.py:293-300)
    mask = (cdr == 0) & ~identity
    positions = np.nonzero(mask)[0].astype(np.int32)
    src = base['clean'].copy()
    src[mask] = C.IDX_MSK
    out = dict(base)
    out.update({'tokens': src, 'positions': positions,
                'pad_to': int(np.count_nonzero(cdr == 0))})
    return out


# Copied from hudiff_tpu/sampling/humanize.py:166-218.
def _is_heavy_type(seq) -> bool:
    """True when ``seq`` is a string that aligns as a heavy-group chain above
    the fragment floor: the acceptance test behind nano_input and the
    nano FASTA record scan."""
    if not isinstance(seq, str) or not seq.strip():
        return False
    try:
        group, _, score = AL.detect_chain_type(seq)
    except ValueError:
        return False
    return group == 'H' and score >= AL.MIN_CHAIN_SCORE


def nano_input(vhh_seq: str, finetune: bool = False, inpaint: bool = False
               ) -> Optional[Dict[str, np.ndarray]]:
    """152-grid input for one nanobody
    (reference batch_input_element, nanosample.py:124-149)."""
    try:
        group, _, score = AL.detect_chain_type(vhh_seq)
    except (ValueError, TypeError):
        return None  # unalignable / non-string input
    if score < AL.MIN_CHAIN_SCORE:
        return None  # fragment / non-antibody input
    if group != 'H':
        # a kappa/lambda light chain aligns fine but is not a nanobody; the
        # chain_hint below bypasses grid_string's heavy gate, so the gate
        # is applied here
        return None
    h = IMGT.grid_string(vhh_seq, heavy=True, chain_hint='VHH')
    if h is None:
        return None
    tokens = _TOK.seq2idx(h['grid'])
    region = np.asarray(C.HEAVY_REGION_INDEX)
    if inpaint:
        cdr = C.INPAINT_HEAVY_CDR_INDEX
        mask = cdr == 0
    elif finetune:
        cdr = C.HEAVY_CDR_KABAT_NO_VERNIER
        mask = (cdr == 0) & (tokens != C.IDX_PAD)
    else:
        cdr = C.HEAVY_CDR_INDEX
        mask = cdr == 0
    positions = np.nonzero(mask)[0].astype(np.int32)
    src = tokens.copy()
    src[mask] = C.IDX_MSK
    return {'tokens': src, 'clean': tokens, 'region': region,
            'positions': positions, 'pad_to': int(np.count_nonzero(cdr == 0)),
            'aho': h['aho']}


def grid_identity(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of identical residues over slots occupied in either grid."""
    occ = (a != C.IDX_PAD) | (b != C.IDX_PAD)
    if occ.sum() == 0:
        return 0.0
    return float(((a == b) & occ).sum() / occ.sum())


def select_most_similar(parental: np.ndarray, candidates: np.ndarray) -> int:
    """Index of the candidate grid most similar to the parental grid
    (reference select_the_most_similarity_seq, sample.py:352-367)."""
    scores = [grid_identity(parental, cand) for cand in candidates]
    return int(np.argmax(scores))


# ---------------------------------------------------------------------------
# Model loading
# ---------------------------------------------------------------------------

def load_denoiser(ckpt_path: str, kind: str, device='cuda', use_bf16: bool = True):
    """(model, finetuned) from a port checkpoint (training/checkpoints.save)
    or a released reference ``.pt``/``.pth``/``.ckpt`` payload, converted on
    load (hudiff_tpu/sampling/humanize.py:240-277); the file's content says
    which. A port checkpoint's ``kind`` decides the model and must be
    ``kind`` ('pair' or 'heavy'). Released payloads: pretraining ones carry
    ``['config']['model']`` and ``['model']``; Ab fine-tune ones
    ``['pretrain_config']`` and ``['model']`` (reference sample.py:446-454);
    Nb fine-tune ones ``['infilling_params']`` and the whole framework's
    state_dict, whose ``infilling_pretrain.`` entries are the denoiser
    (reference nanosample.py:185-193). ``finetuned`` is True for the two
    fine-tune layouts."""
    dev = resolve_device(device)
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    payload = CKPT.load_payload(ckpt_path)
    if CKPT.is_port_payload(payload):
        model, config = CKPT.from_payload(payload, dtype=dtype, device=dev)
        found = config.get('kind', 'pair')
        if kind != found:
            raise ValueError(f'{ckpt_path} holds a {found!r} model, not a {kind!r} one')
        return model, bool(config.get('finetuned', False))
    cfg_dict = payload.get('pretrain_config',
                           payload.get('infilling_params', payload.get('config')))
    cfg = DenoiserConfig.from_dict(dict(cfg_dict['model'] if 'model' in cfg_dict
                                        else cfg_dict))
    state_dict = payload['model']
    if any(k.startswith('infilling_pretrain.') for k in state_dict):
        state_dict = {k.partition('infilling_pretrain.')[2]: v for k, v in state_dict.items()
                      if k.startswith('infilling_pretrain.')}
        finetuned = True
    else:
        finetuned = 'pretrain_config' in payload
    tree = CKPT.convert_torch_denoiser(state_dict, pair=kind == 'pair', nhead=cfg.nhead)
    return CKPT.from_flax_params(tree, cfg, dtype=dtype, device=dev), finetuned


# ---------------------------------------------------------------------------
# Packed batching (copied from hudiff_tpu/sampling/humanize.py:303-370)
# ---------------------------------------------------------------------------

def load_mouse_pairs(data_fpath: str):
    """(name, h_seq, l_seq) rows from a mouse-pair CSV; rows with missing
    sequences are skipped."""
    with open(data_fpath, newline='') as f:
        mouse = [r for r in csv.DictReader(f) if r.get('type', 'mouse') == 'mouse']
    return [(str(r.get('name', i)), r['h_seq'], r['l_seq'])
            for i, r in enumerate(mouse) if r.get('h_seq') and r.get('l_seq')]


def _bucket_order_width(k_used: int, cap: int) -> int:
    """Order width for a batch: its real masked-slot maximum rounded up to a
    multiple of 32, capped at the mode maximum (every order column costs a
    full forward, padded or not)."""
    if k_used >= cap:
        return cap
    return min(cap, ((max(k_used, 1) + 31) // 32) * 32)


def _packed_pad_to(inputs) -> int:
    """Bucketed order width for a packed batch."""
    live = [inp for inp in inputs if inp is not None]
    return _bucket_order_width(
        max((len(inp['positions']) for inp in live), default=0),
        max((inp['pad_to'] for inp in live), default=1))


def _bucket_batch(n: int, cap: int) -> int:
    """Power-of-two bucketed device batch for a packed stream, capped."""
    b = 1
    while b < n:
        b *= 2
    return max(1, min(b, cap))


def iter_packed_chunks(humanizer, stream, pad_to: int):
    """Drive a packed ``(key, inp)`` stream through bucketed
    ``device_batch``-capped rounds, yielding ``(chunk, sampled_rows)``.

    Batch policy: the smallest already-used bucket that fits, else the
    stream's own power-of-two bucket, so shrinking retry waves keep the
    first wave's batch shape.
    """
    if not stream:
        return
    need = _bucket_batch(len(stream), humanizer.device_batch)
    used = getattr(humanizer, '_used_batches', None)
    if used is None:
        used = humanizer._used_batches = set()
    fits = [b for b, p in used if p == pad_to and b >= need]
    B = min(fits) if fits else need
    for s in range(0, len(stream), B):
        chunk = stream[s: s + B]
        yield chunk, humanizer.sample_rows([inp for _, inp in chunk], pad_to,
                                           batch=B)
        # registered only after a successful round
        used.add((B, pad_to))


def _result(inp: Dict, out: np.ndarray) -> Dict:
    h_seqs = [_TOK.idx2seq(row[: C.HEAVY_LEN]) for row in out]
    l_seqs = [_TOK.idx2seq(row[C.HEAVY_LEN:]) for row in out]
    best = select_most_similar(inp['clean'], out)
    return {'h_seqs': h_seqs, 'l_seqs': l_seqs, 'grids': out,
            'best_idx': best, 'best': (h_seqs[best], l_seqs[best])}


class _Humanizer:
    """One denoiser on ``device`` and its sampler.

    The model is moved to ``device``; a bf16 model gets its parameters cast
    to bf16 once, in place (sampler.cast_params_once). Orders are drawn
    from a numpy generator and tokens from a ``torch.Generator`` on the
    device, both seeded with ``seed``. A round runs ceil(pad_to /
    ``positions_per_step``) forwards. ``COND`` names the row keys the model
    is conditioned on."""
    COND: Tuple[str, ...] = ()

    def __init__(self, model, batch_size: int = 16, shuffle: bool = True,
                 seed: int = 2023, device='cuda',
                 device_batch: Optional[int] = None, positions_per_step: int = 1):
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.device_batch = device_batch or batch_size
        self.shuffle = shuffle
        self.positions_per_step = positions_per_step
        self.order_rng = np.random.default_rng(seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.run = S.make_model_sampler(model.to(self.device),
                                        positions_per_step=positions_per_step)

    def _sample(self, rows: List[Dict], pad_to: int) -> np.ndarray:
        put = lambda key: torch.as_tensor(  # noqa: E731
            np.stack([r[key] for r in rows]), dtype=torch.long, device=self.device)
        order = S.build_order_rows([r['positions'] for r in rows],
                                   rng=self.order_rng, shuffle=self.shuffle,
                                   pad_to=pad_to)
        out = self.run(put('tokens'),
                       torch.as_tensor(order, dtype=torch.long, device=self.device),
                       self.generator, *(put(k) for k in self.COND))
        return out.cpu().numpy().astype(np.int32)

    def sample_rows(self, rows: List[Dict], pad_to: int,
                    batch: Optional[int] = None) -> np.ndarray:
        """One round over heterogeneous packed rows (each row dict carries
        its own tokens, conditioning and positions). A short chunk is padded
        by repeating its last row; the extra outputs are dropped."""
        n = len(rows)
        B = batch or self.device_batch
        if not 0 < n <= B:
            raise ValueError(f'sample_rows: {n} rows for a batch of {B}')
        return self._sample(rows + [rows[-1]] * (B - n), pad_to)[:n]

    def _packed_grids(self, inputs: List[Optional[Dict]], rows_per_input: int,
                      pad_to: Optional[int]) -> Dict[int, np.ndarray]:
        """Every input gets ``rows_per_input`` candidate rows; rows from many
        inputs share rounds of ``device_batch`` rows. {input index: grids}."""
        stream: List[Tuple[int, Dict]] = []
        for i, inp in enumerate(inputs):
            if inp is not None:
                stream.extend([(i, inp)] * rows_per_input)
        pad_to = pad_to or _packed_pad_to(inputs)
        grids: Dict[int, List[np.ndarray]] = {}
        for chunk, out in iter_packed_chunks(self, stream, pad_to):
            for (i, _), row in zip(chunk, out):
                grids.setdefault(i, []).append(row)
        return {i: np.stack(g) for i, g in grids.items()}


class PairHumanizer(_Humanizer):
    """Humanizes paired antibodies with one ``AntiTFNet`` on ``device``."""
    COND = ('region', 'chain')

    def __call__(self, h_seq: str, l_seq: str, finetune: bool = False,
                 inpaint: bool = False) -> Optional[Dict[str, object]]:
        inp = (pair_inpaint_input(h_seq, l_seq) if inpaint
               else pair_input(h_seq, l_seq, finetune=finetune))
        if inp is None:
            return None
        out = self._sample([inp] * self.batch_size, _bucket_order_width(
            len(inp['positions']), inp['pad_to']))
        return _result(inp, out)

    def humanize_many(self, inputs: List[Optional[Dict]], rows_per_input: int,
                      pad_to: Optional[int] = None) -> List[Optional[Dict]]:
        """Every antibody gets ``rows_per_input`` candidate rows; rows from
        many antibodies share rounds of ``device_batch`` rows."""
        grids = self._packed_grids(inputs, rows_per_input, pad_to)
        return [None if inp is None or i not in grids else _result(inp, grids[i])
                for i, inp in enumerate(inputs)]


def _nano_result(inp: Dict, out: np.ndarray) -> Optional[Dict]:
    """The candidates that still align as heavy chains (reference
    nanosample.py:338-353), the best of them by grid identity; None when
    none does."""
    seqs = [_TOK.idx2seq(row) for row in out]
    valid = [k for k, a in enumerate(AL.align_to_aho_batch(seqs, 'H')) if a is not None]
    if not valid:
        return None
    grids = out[valid]
    vseqs = [seqs[k] for k in valid]
    best = select_most_similar(inp['clean'], grids)
    return {'seqs': vseqs, 'grids': grids, 'best_idx': best, 'best': vseqs[best]}


class NanoHumanizer(_Humanizer):
    """Humanizes nanobodies with one ``NanoAntiTFNet`` on ``device``.

    A candidate is returned only if it still aligns as a heavy chain; the
    filter runs the pure-Python aligner on the host, and ``filter_s``
    accumulates the seconds it took."""
    COND = ('region',)

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.filter_s = 0.0

    def _filtered(self, inp: Dict, out: np.ndarray) -> Optional[Dict]:
        t0 = time.perf_counter()
        try:
            return _nano_result(inp, out)
        finally:
            self.filter_s += time.perf_counter() - t0

    def humanize_many(self, inputs: List[Optional[Dict]], rows_per_input: int,
                      pad_to: Optional[int] = None) -> List[Optional[Dict]]:
        """Packed nanobody humanization with the validity filter applied
        per nanobody."""
        grids = self._packed_grids(inputs, rows_per_input, pad_to)
        return [None if inp is None or i not in grids else self._filtered(inp, grids[i])
                for i, inp in enumerate(inputs)]

    def __call__(self, vhh_seq: str, finetune: bool = False, inpaint: bool = False,
                 max_retry: int = 3) -> Optional[Dict[str, object]]:
        """``batch_size`` candidates for one nanobody, resampled up to
        ``max_retry`` rounds until one aligns as a heavy chain."""
        inp = nano_input(vhh_seq, finetune=finetune, inpaint=inpaint)
        if inp is None:
            return None
        pad_to = _bucket_order_width(len(inp['positions']), inp['pad_to'])
        for _ in range(max_retry):
            res = self._filtered(inp, self._sample([inp] * self.batch_size, pad_to))
            if res is not None:
                return res
        return None


# ---------------------------------------------------------------------------
# CLI (hudiff_tpu/sampling/humanize.py:584-980)
# ---------------------------------------------------------------------------

def collect_unique(sample_fn, target: int, max_retry: int):
    """Resample until ``target`` unique candidates or the retry cap; a None
    round is not terminal. Returns ``(unique, failed)``."""
    unique: list = []
    seen: set = set()
    failed = False
    for _ in range(max_retry):
        cands = sample_fn()
        if cands is None:
            failed = True
            continue
        _dedup_into(seen, unique, cands, target)
        if len(unique) >= target:
            break
    return unique, failed


def _dedup_into(seen: set, unique: list, cands, target: int) -> None:
    for c in cands:
        if c not in seen and len(unique) < target:
            seen.add(c)
            unique.append(c)


def _write_csv_header(path: str) -> None:
    with open(path, 'w', encoding='UTF-8') as f:
        f.write('Specific,name,hseq,lseq,\n')


def run_ab(args) -> str:
    model, finetuned = load_denoiser(args.ckpt, device=args.device,
                                     use_bf16=not args.fp32, kind='pair')
    finetune = (args.ckpt_version == 'finetune') if args.ckpt_version else finetuned
    log_dir = get_new_log_dir(args.logdir, prefix=f'ab_humanize_{args.seed}')
    logger = get_logger('humanize', log_dir)
    save_fpath = os.path.join(log_dir, 'sample_humanization_result.csv')
    _write_csv_header(save_fpath)

    hum = PairHumanizer(model, batch_size=args.batch_size,
                        shuffle=(args.sample_order == 'shuffle'),
                        seed=args.seed, device=args.device,
                        device_batch=max(args.pack_size, args.batch_size),
                        positions_per_step=args.positions_per_step)
    inpaint = args.sample_method == 'inpaint'

    if args.fasta:
        from ..eval.biophi import pair_from_fasta
        h_seq, l_seq = pair_from_fasta(args.fasta)
        pairs = [(os.path.basename(args.fasta), h_seq, l_seq)]
    elif args.hseq and args.lseq:
        pairs = [('input', args.hseq, args.lseq)]
    elif args.data_fpath:
        pairs = load_mouse_pairs(args.data_fpath)
    else:
        raise SystemExit('ab needs --hseq/--lseq, --fasta or --data-fpath')

    if len(pairs) > 1:
        _packed_pair_loop(hum, pairs, finetune, inpaint, args, logger, save_fpath)
    else:
        for name, h_seq, l_seq in pairs:
            with open(save_fpath, 'a', encoding='UTF-8') as f:
                f.write(f'mouse,{name},{h_seq},{l_seq}\n')

            def round_fn():
                res = hum(h_seq, l_seq, finetune=finetune, inpaint=inpaint)
                if res is None:
                    return None
                return ([res['best']] if args.similarity_search
                        else list(zip(res['h_seqs'], res['l_seqs'])))

            target = 1 if args.similarity_search else args.sample_number
            unique, failed = collect_unique(round_fn, target, args.max_retry)
            if failed and not unique:
                logger.warning('could not align %s; skipped', name)
                continue
            with open(save_fpath, 'a', encoding='UTF-8') as f:
                for g_h, g_l in unique:
                    f.write(f'humanization,{name}human_sample,{g_h},{g_l}\n')
            logger.info('humanized %s (%d candidates)', name, len(unique))
    _ab_epilogue(save_fpath, args, logger)
    logger.info('results: %s', save_fpath)
    return save_fpath


def _ab_epilogue(save_fpath: str, args, logger) -> None:
    """A paired FASTA for BioPhi OASis next to the CSV, and per-antibody
    FASTAs with --structure-fasta."""
    from ..eval import biophi as BP
    base = os.path.dirname(save_fpath)
    BP.sample_csv_to_fasta(save_fpath, os.path.join(base, 'sample_identity.fa'),
                           version=args.fa_version)
    if args.structure_fasta:
        fa_dir = os.path.join(base, 'sample_human_fa')
        os.makedirs(fa_dir, exist_ok=True)
        with open(save_fpath, newline='') as f:
            human = [r for r in csv.DictReader(f) if r['Specific'] == 'humanization']
        for i, r in enumerate(human):
            BP.write_pair_fasta([(r['name'], r['hseq'], r['lseq'])],
                                os.path.join(fa_dir, f'human_{i}.fasta'))


def _packed_pair_loop(hum: PairHumanizer, pairs, finetune: bool, inpaint: bool, args,
                      logger, save_fpath: str) -> None:
    """Dataset-scale humanization: candidate rows of every unfinished
    antibody share rounds (PairHumanizer.humanize_many); per-antibody
    semantics are those of the single-antibody loop."""
    n = len(pairs)
    inputs = [pair_inpaint_input(h_seq, l_seq) if inpaint
              else pair_input(h_seq, l_seq, finetune=finetune) for _, h_seq, l_seq in pairs]
    target = 1 if args.similarity_search else args.sample_number
    unique: List[list] = [[] for _ in range(n)]
    seen: List[set] = [set() for _ in range(n)]
    run_pad_to = _packed_pad_to(inputs)
    for _ in range(args.max_retry):
        active = [i for i in range(n)
                  if inputs[i] is not None and len(unique[i]) < target]
        if not active:
            break
        results = hum.humanize_many([inputs[i] for i in active],
                                    rows_per_input=args.batch_size,
                                    pad_to=run_pad_to)
        for i, res in zip(active, results):
            if res is None:
                continue
            cands = ([res['best']] if args.similarity_search
                     else list(zip(res['h_seqs'], res['l_seqs'])))
            _dedup_into(seen[i], unique[i], cands, target)
    with open(save_fpath, 'a', encoding='UTF-8') as f:
        for i, (name, h_seq, l_seq) in enumerate(pairs):
            f.write(f'mouse,{name},{h_seq},{l_seq}\n')
            if inputs[i] is None:
                logger.warning('could not align %s; skipped', name)
                continue
            for g_h, g_l in unique[i]:
                f.write(f'humanization,{name}human_sample,{g_h},{g_l}\n')
            logger.info('humanized %s (%d candidates)', name, len(unique[i]))


def load_vhh_rows(data_fpath: str, logger=None) -> List[Tuple[str, str]]:
    """(row index, sequence) of each non-empty cell of a CSV's ``vhhseq``
    (else ``vhh_seq``) column; empty cells are skipped with a warning."""
    with open(data_fpath, newline='') as f:
        reader = csv.DictReader(f)
        col = 'vhhseq' if 'vhhseq' in (reader.fieldnames or ()) else 'vhh_seq'
        cells = [r.get(col) for r in reader]
    rows = [(str(i), s) for i, s in enumerate(cells) if s and s.strip()]
    if len(rows) < len(cells) and logger is not None:
        logger.warning('skipped %d rows with missing %s', len(cells) - len(rows), col)
    return rows


def run_nano(args) -> str:
    model, finetuned = load_denoiser(args.ckpt, device=args.device,
                                     use_bf16=not args.fp32, kind='heavy')
    finetune = (args.ckpt_version == 'finetune') if args.ckpt_version else finetuned
    log_dir = get_new_log_dir(args.logdir, prefix=f'nano_humanize_{args.seed}')
    logger = get_logger('humanize', log_dir)
    save_fpath = os.path.join(log_dir, 'sample_humanization_result.csv')
    with open(save_fpath, 'w', encoding='UTF-8') as f:
        f.write('Specific,name,vhh_seq,\n')

    hum = NanoHumanizer(model, batch_size=args.batch_size,
                        shuffle=(args.sample_order == 'shuffle'), seed=args.seed,
                        device=args.device,
                        device_batch=max(args.pack_size, args.batch_size),
                        positions_per_step=args.positions_per_step)
    inpaint = args.sample_method == 'inpaint'
    if args.fasta:
        # the first heavy-type record, so that a complex FASTA whose first
        # record is a light chain is not humanized as a nanobody
        from ..eval.biophi import read_fasta
        records = read_fasta(args.fasta)
        rec = next((r for r in records if _is_heavy_type(r[1])), None)
        if rec is None:
            raise SystemExit(f'no heavy-type record found in {args.fasta} '
                             f'({len(records)} records scanned)')
        rows = [(rec[0].split()[0], rec[1])]
    elif args.vhh_seq:
        rows = [('input', args.vhh_seq)]
    elif args.data_fpath:
        rows = load_vhh_rows(args.data_fpath, logger)
    else:
        raise SystemExit('nano needs --vhh-seq, --fasta or --data-fpath')

    if len(rows) > 1:
        _packed_nano_loop(hum, rows, finetune, inpaint, args, logger, save_fpath)
        logger.info('results: %s', save_fpath)
        return save_fpath
    for name, seq in rows:
        with open(save_fpath, 'a', encoding='UTF-8') as f:
            f.write(f'camel,{name},{seq}\n')

        def round_fn():
            res = hum(seq, finetune=finetune, inpaint=inpaint)
            if res is None:
                return None
            return [res['best']] if args.similarity_search else res['seqs']

        target = 1 if args.similarity_search else args.sample_number
        unique, failed = collect_unique(round_fn, target, args.max_retry)
        if failed and not unique:
            logger.warning('could not align/humanize %s; skipped', name)
            continue
        with open(save_fpath, 'a', encoding='UTF-8') as f:
            for sq in unique:
                f.write(f'humanization,{name}human_sample,{sq}\n')
        logger.info('humanized %s (%d candidates)', name, len(unique))
    logger.info('results: %s', save_fpath)
    return save_fpath


def _packed_nano_loop(hum: NanoHumanizer, rows, finetune: bool, inpaint: bool, args,
                      logger, save_fpath: str) -> None:
    """Dataset-scale nanobody humanization: candidate rows of every
    unfinished nanobody share rounds (NanoHumanizer.humanize_many);
    per-nanobody semantics are those of the single-nanobody loop."""
    n = len(rows)
    inputs = [nano_input(seq, finetune=finetune, inpaint=inpaint) for _, seq in rows]
    target = 1 if args.similarity_search else args.sample_number
    unique: List[list] = [[] for _ in range(n)]
    seen: List[set] = [set() for _ in range(n)]
    run_pad_to = _packed_pad_to(inputs)
    for _ in range(args.max_retry):
        active = [i for i in range(n)
                  if inputs[i] is not None and len(unique[i]) < target]
        if not active:
            break
        results = hum.humanize_many([inputs[i] for i in active],
                                    rows_per_input=args.batch_size, pad_to=run_pad_to)
        for i, res in zip(active, results):
            if res is not None:
                cands = [res['best']] if args.similarity_search else res['seqs']
                _dedup_into(seen[i], unique[i], cands, target)
    with open(save_fpath, 'a', encoding='UTF-8') as f:
        for i, (name, seq) in enumerate(rows):
            f.write(f'camel,{name},{seq}\n')
            if inputs[i] is None or not unique[i]:
                logger.warning('could not align/humanize %s; skipped', name)
                continue
            for sq in unique[i]:
                f.write(f'humanization,{name}human_sample,{sq}\n')
            logger.info('humanized %s (%d candidates)', name, len(unique[i]))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest='cmd', required=True)
    for name in ('ab', 'nano'):
        q = sub.add_parser(name)
        q.add_argument('--ckpt', required=True,
                       help='port checkpoint (.pt) or released reference .pt')
        q.add_argument('--ckpt-version', choices=['pretrain', 'finetune'], default=None)
        q.add_argument('--data-fpath', default=None)
        q.add_argument('--batch-size', type=int, default=16)
        q.add_argument('--sample-number', type=int, default=1)
        q.add_argument('--max-retry', type=int, default=8,
                       help='resampling rounds to reach --sample-number unique candidates')
        q.add_argument('--seed', type=int, default=2023)
        q.add_argument('--sample-order', default='shuffle',
                       choices=['shuffle', 'sequential'])
        q.add_argument('--similarity-search', action='store_true', default=True)
        q.add_argument('--no-similarity-search', dest='similarity_search',
                       action='store_false')
        q.add_argument('--logdir', default='./logs')
        q.add_argument('--fp32', action='store_true')
        q.add_argument('--pack-size', type=int, default=256,
                       help='device batch for dataset-mode packed sampling')
        q.add_argument('--positions-per-step', type=int, default=1,
                       help='resample k positions per forward (k > 1: the OA-ARDM '
                            'acceleration, ~k x fewer forwards; 1: the reference)')
        q.add_argument('--sample-method', default='FR', choices=['FR', 'inpaint'],
                       help='FR: resample every framework slot; inpaint: ab grafts '
                            'the CDRs onto the nearest germline and resamples the '
                            'framework slots that differ from it, nano uses the '
                            'inpainting mask (INPAINT_HEAVY_CDR_INDEX)')
        q.add_argument('--device', default='cuda',
                       help="torch device; 'cpu' runs the plain versions of the kernels")
        if name == 'ab':
            q.add_argument('--fasta', default=None,
                           help='humanize the chain pair in this FASTA')
            q.add_argument('--hseq', default=None)
            q.add_argument('--lseq', default=None)
            q.add_argument('--fa-version', default='v001',
                           help='name prefix for the exported BioPhi FASTA')
            q.add_argument('--structure-fasta', action='store_true',
                           help='also write per-antibody FASTAs for structure prediction')
        else:
            q.add_argument('--fasta', default=None,
                           help="humanize this FASTA's first heavy-type record")
            q.add_argument('--vhh-seq', default=None)
    # the model-free CDR-graft baseline (reference cdr_pair_grafting,
    # sample.py:370-376): germline FRs + parental CDRs
    g = sub.add_parser('graft')
    g.add_argument('--hseq', default=None)
    g.add_argument('--lseq', default=None)
    g.add_argument('--data-fpath', default=None,
                   help='CSV of mouse pairs: graft the whole dataset')
    g.add_argument('--back-mutation', action='store_true',
                   help='back-mutate Kabat vernier-zone residues to parental')
    g.add_argument('--output', default=None, help='CSV path (default stdout)')
    args = p.parse_args(argv)
    if args.cmd == 'graft':
        return run_graft(args)
    seed_all(args.seed)
    return run_ab(args) if args.cmd == 'ab' else run_nano(args)


def run_graft(args) -> Optional[str]:
    """CDR-graft ``--hseq/--lseq`` or every pair of ``--data-fpath`` (a row
    that does not graft keeps its parental line and is skipped with a
    warning); writes the CSV to ``--output`` (and prints its path) or to
    stdout."""
    from ..numbering import germline as G
    rows = []
    if args.data_fpath:
        logger = get_logger('graft')
        for name, h_seq, l_seq in load_mouse_pairs(args.data_fpath):
            rows.append(('mouse', name, h_seq, l_seq))
            try:
                h, l = G.cdr_pair_grafting(h_seq, l_seq, back_mutation=args.back_mutation)
            except Exception as e:  # noqa: BLE001 - skip unalignable rows
                logger.warning('skipping graft for %s: %s', name, e)
                continue
            rows.append(('humanization', f'{name}human_sample', h, l))
    elif args.hseq and args.lseq:
        h, l = G.cdr_pair_grafting(args.hseq, args.lseq, back_mutation=args.back_mutation)
        rows.append(('cdr_graft', 'graft_sample', h, l))
    else:
        raise SystemExit('graft needs --hseq/--lseq or --data-fpath')
    text = 'Specific,name,hseq,lseq\n' + ''.join(f'{a},{b},{c},{d}\n' for a, b, c, d in rows)
    if args.output:
        with open(args.output, 'w') as f:
            f.write(text)
        print(args.output)
        return args.output
    print(text, end='')
    return None


if __name__ == '__main__':
    main()
