"""Quality curve for the ``--positions-per-step`` sampling dial, on the card.

Counterpart of tools/pps_quality.py. The reference reverse process resamples
one position a forward; ``--positions-per-step k`` samples k positions of a
step independently, for about k times fewer forwards. This tool measures
what that costs:

1. ``train_tiny``: the test-size HuDiff-Ab trained on the experimentally
   humanized pairs of a pair CSV (HuAb348) with the port's train step
   (``training/train_step.make_pair_train_step``, Adam lr 3e-4, clip 10,
   B = 32, f32);
2. ``eval_one_setting``: the mouse pairs humanized at each k over several
   sampling seeds (one humanizer a k, re-seeded a call; bf16 sampling, as
   the JAX sampler casts once);
3. mean and 95% CI (t over seeds) of preservation and germline FR identity
   per k, and the seed-paired drift against k = 1.

``HUAB348`` is the CSV it reads (``type``, ``name``, ``h_seq``, ``l_seq``;
read with ``csv``, no pandas). It has no default; set it, then call
``main`` with the command line's arguments:

    python -c 'from hudiff_tpu_torch.tools import pps_quality as P;
               P.HUAB348 = "<pair csv>"; P.main()' [--train-steps 300]
        [--n-mice 64] [--seeds 2023,2024,2025] [--rows-per-mouse 16]
        [--device-batch 128] [--ks 1,2,4,8] [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import json
import sys
from typing import Optional

import numpy as np

from . import dataset_csv

# The upstream release's HuAb348 pair CSV
# (antibody_eval_data/HuAb348_data/humanization_pair_data_filter.csv). It is
# not in the repository, so it has no default: set it before running the tool.
HUAB348: Optional[str] = None

# two-sided 97.5% t quantiles for small seed counts (df = n-1)
_T975 = {1: float('nan'), 2: 12.706, 3: 4.303, 4: 3.182, 5: 2.776,
         6: 2.571, 7: 2.447, 8: 2.365, 9: 2.306, 10: 2.262}

METRICS = ('preservation_h', 'preservation_l', 'germline_fr_h', 'germline_fr_l')


def mean_ci(vals):
    """(mean, 95% CI half-width) over independent seed-level values; past
    10 seeds the df = 9 quantile (2.262) is kept as a conservative cap."""
    v = np.asarray(vals, np.float64)
    n = len(v)
    m = float(v.mean())
    if n < 2:
        return m, float('nan')
    hw = _T975.get(n, _T975[10]) * float(v.std(ddof=1)) / np.sqrt(n)
    return m, float(hw)


def _rows(kind: str):
    with open(dataset_csv(HUAB348, 'HUAB348'), newline='') as f:
        return [r for r in csv.DictReader(f) if r.get('type') == kind]


def train_tiny(train_steps: int, device='cuda'):
    """The test-size ``AntiTFNet`` trained ``train_steps`` steps on the CSV's
    humanized pairs; returns the model (f32, train mode off)."""
    import torch

    from ..models.denoiser import AntiTFNet, DenoiserConfig
    from ..sampling import humanize as H
    from ..training import schedules
    from ..training import train_step as T
    from ..utils.config import Namespace
    from ..utils.device import resolve_device

    dev = resolve_device(device)
    grids, chains = [], []
    for r in _rows('humanized'):
        inp = H.pair_input(r['h_seq'], r['l_seq'])
        if inp is None:
            continue
        grids.append(inp['clean'])
        chains.append(inp['chain'])
    tokens_all = np.stack(grids)
    chains_all = np.stack(chains)
    print(f'training pairs: {len(tokens_all)}', file=sys.stderr)

    torch.manual_seed(0)
    model = AntiTFNet(DenoiserConfig().test_size(), device=dev)
    optimizer = schedules.make_optimizer(Namespace({'type': 'Adam', 'lr': 3e-4}),
                                         model.parameters())
    state = T.TrainState(model, optimizer, clip_norm=10.0)
    step = T.make_pair_train_step(model)
    rs = np.random.RandomState(0)
    model.train()
    B = 32
    for i in range(train_steps):
        ix = rs.randint(0, len(tokens_all), B)
        m = step(state, torch.as_tensor(tokens_all[ix], dtype=torch.long, device=dev),
                 torch.as_tensor(chains_all[ix], dtype=torch.long, device=dev), 1)
        if (i + 1) % 100 == 0:
            print(f'step {i + 1}: loss {float(m["loss"]):.4f}', file=sys.stderr)
    return model.eval()


def sampling_model(model, use_bf16: bool = True):
    """A copy of ``model`` computing in bf16 (the sampler casts its weights
    once), or ``model`` itself."""
    if not use_bf16:
        return model
    import torch

    from ..models.denoiser import AntiTFNet
    out = AntiTFNet(model.cfg, dtype=torch.bfloat16, device='cpu')
    out.load_state_dict({k: v.detach().cpu() for k, v in model.state_dict().items()})
    return out.eval()


def load_mice(n_mice: int):
    """(name, pair_input) of the first ``n_mice`` mouse pairs that align."""
    from ..sampling import humanize as H
    mice = []
    for r in _rows('mouse'):
        inp = H.pair_input(r['h_seq'], r['l_seq'])
        if inp is not None:
            mice.append((str(r['name']), inp))
        if len(mice) == n_mice:
            break
    return mice


def eval_one_setting(hum, mice, seed: int, rows_per_mouse: int):
    """Humanize every mouse (best of ``rows_per_mouse``) on a shared
    humanizer of one k, re-seeded here; per-metric means over mice."""
    from .. import constants as C
    from ..numbering import germline as G

    hum.order_rng = np.random.default_rng(seed)
    hum.generator.manual_seed(seed)
    results = hum.humanize_many([inp for _, inp in mice], rows_per_input=rows_per_mouse)
    prot = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX]) != 0
    pres_h, pres_l, germ_h, germ_l, cdr_ok = [], [], [], [], []
    for (name, inp), res in zip(mice, results):
        best = res['grids'][res['best_idx']]
        par = inp['clean']
        cdr_ok.append(bool((best[prot] == par[prot]).all()))
        pres_h.append(float((best[:C.HEAVY_LEN] == par[:C.HEAVY_LEN]).mean()))
        pres_l.append(float((best[C.HEAVY_LEN:] == par[C.HEAVY_LEN:]).mean()))
        bh, bl = res['best']
        try:
            germ_h.append(G.germline_fr_identity(bh, 'H'))
            germ_l.append(G.germline_fr_identity(bl))
        except ValueError:
            pass
    return {'preservation_h': float(np.mean(pres_h)),
            'preservation_l': float(np.mean(pres_l)),
            'germline_fr_h': float(np.mean(germ_h)),
            'germline_fr_l': float(np.mean(germ_l)),
            'cdr_invariant': all(cdr_ok)}


def summarize(per_seed, ks, seeds):
    """The per-k table: each metric's mean and CI over seeds, the CDR
    invariant, and the seed-paired drift against the first k."""
    table = {}
    for k in ks:
        row = {}
        for m in METRICS:
            mean, hw = mean_ci([per_seed[k][s][m] for s in seeds])
            row[m] = {'mean': round(mean, 4), 'ci95': round(hw, 4)}
        row['cdr_invariant'] = all(per_seed[k][s]['cdr_invariant'] for s in seeds)
        if k != ks[0]:
            for m in ('preservation_h', 'germline_fr_h'):
                mean, hw = mean_ci([per_seed[k][s][m] - per_seed[ks[0]][s][m]
                                    for s in seeds])
                row[f'd_{m}_vs_k1'] = {'mean': round(mean, 4), 'ci95': round(hw, 4)}
        table[k] = row
    return table


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--train-steps', type=int, default=300)
    p.add_argument('--n-mice', type=int, default=64)
    p.add_argument('--seeds', default='2023,2024,2025')
    p.add_argument('--rows-per-mouse', type=int, default=16)
    p.add_argument('--device-batch', type=int, default=128)
    p.add_argument('--ks', default='1,2,4,8')
    p.add_argument('--device', default='cuda', help="'cpu' to run on the CPU (f32)")
    args = p.parse_args(argv)

    from ..sampling import humanize as H

    model = train_tiny(args.train_steps, args.device)
    sampler_model = sampling_model(model, use_bf16=args.device != 'cpu')
    mice = load_mice(args.n_mice)
    print(f'mice: {len(mice)}', file=sys.stderr)
    ks = [int(k) for k in args.ks.split(',')]
    seeds = [int(s) for s in args.seeds.split(',')]
    per_seed = {k: {} for k in ks}
    for k in ks:
        # one humanizer a k; the seeds re-seed it
        hum = H.PairHumanizer(sampler_model, batch_size=args.rows_per_mouse,
                              device_batch=args.device_batch, positions_per_step=k,
                              device=args.device)
        for seed in seeds:
            per_seed[k][seed] = eval_one_setting(hum, mice, seed, args.rows_per_mouse)
            print(f'k={k} seed={seed}: '
                  + ' '.join(f'{m}={per_seed[k][seed][m]:.4f}' for m in METRICS),
                  file=sys.stderr)
    out = {'n_mice': len(mice), 'seeds': seeds, 'rows_per_mouse': args.rows_per_mouse,
           'train_steps': args.train_steps, 'per_k': summarize(per_seed, ks, seeds)}
    print(json.dumps(out, indent=2))
    return out


if __name__ == '__main__':
    main()
