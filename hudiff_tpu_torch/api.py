"""High-level one-call API, in PyTorch.

Counterpart of hudiff_tpu/api.py: everything the CLIs do, callable from
Python with humanizer caching:

    import hudiff_tpu_torch.api as hd
    cands = hd.humanize_pair(h_seq, l_seq, ckpt='hudiffab.pt', n=3)
    scores = hd.nativeness(seqs, 'VHH', ckpt='VHH_model.ckpt')
    hseq, lseq = hd.graft(h_seq, l_seq)           # model-free CDR graft
    report = hd.evaluate_ab('samples.csv', 'humanization_pair_data.csv')

Checkpoints are the port's own files (training/checkpoints.save, a
pretraining or fine-tune ``step_<it>.pt``) or the released reference
``.pt`` files, converted on load; the JAX package's Orbax directories are
refused. The models run on ``cuda`` unless the caller passes
``device='cpu'``; loaded humanizers are cached per (ckpt, options, device)
so that repeated calls pay only the device rounds.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

_HUMANIZER_CACHE: Dict[tuple, object] = {}


def _humanizer(ckpt: str, kind: str, batch_size: int, seed: int,
               positions_per_step: int, use_bf16: bool, device):
    from .sampling import humanize as H
    from .utils.device import resolve_device
    dev = resolve_device(device)
    key = (ckpt, kind, batch_size, seed, positions_per_step, use_bf16, str(dev))
    if key not in _HUMANIZER_CACHE:
        if os.path.isdir(ckpt):
            raise ValueError(f'{ckpt} is a directory: Orbax checkpoints are the JAX '
                             "package's; the port reads its own .pt files and the "
                             'released reference .pt files')
        model, finetuned = H.load_denoiser(ckpt, 'pair' if kind == 'ab' else 'heavy',
                                           device=dev, use_bf16=use_bf16)
        cls = H.PairHumanizer if kind == 'ab' else H.NanoHumanizer
        hum = cls(model, batch_size=batch_size, seed=seed, device=dev,
                  positions_per_step=positions_per_step)
        _HUMANIZER_CACHE[key] = (hum, finetuned)
    return _HUMANIZER_CACHE[key]


def humanize_pair(h_seq: str, l_seq: str, ckpt: str, n: int = 1,
                  method: str = 'FR', batch_size: int = 16,
                  seed: int = 2023, positions_per_step: int = 1,
                  max_retry: int = 8, use_bf16: bool = True, device='cuda'
                  ) -> List[Tuple[str, str]]:
    """Humanize one VH/VL pair; returns up to ``n`` unique (h, l) candidates
    (best-of-batch by parental preservation when n == 1)."""
    from .sampling.humanize import collect_unique
    hum, finetuned = _humanizer(ckpt, 'ab', batch_size, seed, positions_per_step,
                                use_bf16, device)

    def round_fn():
        res = hum(h_seq, l_seq, finetune=finetuned, inpaint=method == 'inpaint')
        if res is None:
            return None
        return [res['best']] if n == 1 else list(zip(res['h_seqs'], res['l_seqs']))

    unique, failed = collect_unique(round_fn, n, max_retry)
    if failed and not unique:
        raise ValueError('chains did not align to the IMGT grid')
    return unique


def humanize_vhh(vhh_seq: str, ckpt: str, n: int = 1, method: str = 'FR',
                 batch_size: int = 16, seed: int = 2023,
                 positions_per_step: int = 1, max_retry: int = 8,
                 use_bf16: bool = True, device='cuda') -> List[str]:
    """Humanize one nanobody; returns up to ``n`` unique VHH candidates."""
    from .sampling.humanize import collect_unique
    hum, finetuned = _humanizer(ckpt, 'nano', batch_size, seed, positions_per_step,
                                use_bf16, device)

    def round_fn():
        res = hum(vhh_seq, finetune=finetuned, inpaint=method == 'inpaint')
        if res is None:
            return None
        return [res['best']] if n == 1 else res['seqs']

    unique, failed = collect_unique(round_fn, n, max_retry)
    if failed and not unique:
        raise ValueError('sequence did not align / no valid candidates')
    return unique


def graft(h_seq: str, l_seq: str, back_mutation: bool = False) -> Tuple[str, str]:
    """Model-free classic CDR graft onto the nearest human germlines."""
    from .numbering import germline as G
    return G.cdr_pair_grafting(h_seq, l_seq, back_mutation=back_mutation)


def nativeness(seqs: List[str], model_type: str, ckpt: str,
               batch_size: int = 64, device='cuda') -> List[float]:
    """AbNatiV nativeness scores (VH / VKappa / VLambda / VHH) by the f32
    scorer on ``device``; NaN for unalignable sequences."""
    from .eval.harness import abnativ_scores_local
    return abnativ_scores_local(seqs, model_type, ckpt, batch_size=batch_size, device=device)


def germline_identity(seq: str, group: Optional[str] = None) -> float:
    """Framework identity of a chain vs its nearest-germline CDR graft."""
    from .numbering import germline as G
    return G.germline_fr_identity(seq, group)


def evaluate_ab(sample_csv: str, pair_csv: str, **kwargs) -> Dict:
    """Full antibody eval battery (eval.harness.eval_ab)."""
    from .eval.harness import eval_ab
    return eval_ab(sample_csv, pair_csv, **kwargs)


def evaluate_nano(sample_csv: str, **kwargs) -> Dict:
    """Nanobody eval battery (eval.harness.eval_nano)."""
    from .eval.harness import eval_nano
    return eval_nano(sample_csv, **kwargs)
