"""Dataset-scale paired humanization: rounds of many antibodies' candidate
rows packed into one device batch (the ``humanize ab --data-fpath`` path).

Traffic parameters (``traffic/<mix>.json``): ``parents`` (a data file of
parent pairs with their CDRs), ``pool`` (antibodies made at set-up, framework
mutants of the parents with ``mutations_per_chain`` substitutions each, kept
only if ``pair_input`` numbers them), ``antibodies_per_round``,
``rows_per_antibody`` (``--batch-size``), ``pack_size`` (``--pack-size``),
and ``finetune_mask``. The compute type is the configuration's ``dtype``.

A unit is one round: ``pair_input`` for each of the round's antibodies (the
host prep, a harness span), each antibody's masked slots shuffled into its
order, then ``PairHumanizer.humanize_many`` over them, whose rounds replay
a CUDA graph on the card. The round's generator is seeded from the run's
seed and the round's index, as one CLI invocation seeds it. The width of
every round is the CLI's bucketed width over the whole pool.

The check, once the window has closed: every served row's write-back and
start (``reference/sampling.py``) and the widest gap of a sample of rows,
the longest among them, against the float32 reference.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import generate as G
from benchmark import yardstick as Y
from benchmark.reference import denoiser as R
from benchmark.reference import sampling as RS
from benchmark import weights

from hudiff_tpu_torch.models.denoiser import AntiTFNet, DenoiserConfig
from hudiff_tpu_torch.sampling import humanize as HZ

class Driver:
    kind = 'pair'

    def __init__(self, run):
        self.run, self.t = run, run.traffic
        self.dev = run.device
        self.tables = G.imgt()
        self.rounds = []            # what each round was given and served
        self.n_failed = 0

    # -- set-up ---------------------------------------------------------------
    def _model(self):
        cfg = DenoiserConfig.from_dict(self.run.cfg)
        model = AntiTFNet(cfg, dtype=getattr(torch, self.run.cfg['dtype']), device=self.dev)
        shapes = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
        self.params = weights.make(shapes, self.run.seed, self.dev)
        model.load_state_dict(self.params)
        return model

    def _pool(self):
        rng = G.seed_sequence(self.run.seed, 1)
        parents = G.load_data(self.t['parents'])['pairs']
        pool, tries = [], 0
        while len(pool) < self.t['pool']:
            tries += 1
            if tries > 8 * self.t['pool']:
                raise RuntimeError('too few framework mutants number as antibodies')
            p = parents[len(pool) % len(parents)]
            n = self.t['mutations_per_chain']
            h = G.framework_mutant(p['h'], p['h_cdrs'], n, rng)
            l = G.framework_mutant(p['l'], p['l_cdrs'], n, rng)
            inp = HZ.pair_input(h, l, finetune=self.t['finetune_mask'])
            if inp is not None:
                pool.append({'h': h, 'l': l, 'light_type': p['light_type'],
                             'k': len(inp['positions']), 'cap': inp['pad_to']})
        return pool

    def setup(self):
        model = self._model()
        self.run.mark('model')
        self.pool = self._pool()
        self.width = G.bucket_width(max(a['k'] for a in self.pool),
                                    max(a['cap'] for a in self.pool))
        self.hum = HZ.PairHumanizer(model, batch_size=self.t['rows_per_antibody'],
                                    shuffle=False, seed=self.run.seed, device=self.dev,
                                    device_batch=self.t['pack_size'])
        self.run.mark('pool')
        self.order_rng = G.seed_sequence(self.run.seed, 2)
        self.unit()                  # captures the round's graph
        self.rounds.clear()
        self.n_failed = 0

    # -- the window -----------------------------------------------------------
    def unit(self):
        n = self.t['antibodies_per_round']
        picks = [int(i) for i in self.order_rng.integers(0, len(self.pool), n)]
        with self.run.span('pair_input'):
            inputs = [HZ.pair_input(self.pool[i]['h'], self.pool[i]['l'],
                                    finetune=self.t['finetune_mask']) for i in picks]
        for inp in inputs:
            if inp is not None:
                inp['positions'] = self.order_rng.permutation(inp['positions'])
        seed = int(G.seed_sequence(self.run.seed, 3, len(self.rounds)).integers(2 ** 62))
        self.hum.generator.manual_seed(seed)
        with self.run.span('humanize_many'):
            out = self.hum.humanize_many(inputs, rows_per_input=self.t['rows_per_antibody'],
                                         pad_to=self.width)
        self.n_failed += sum(r is None for r in out)
        self.rounds.append({'seed': seed, 'picks': picks, 'inputs': inputs, 'out': out})

    def settle(self):
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)

    def rows(self) -> int:
        return sum(len(r['grids']) for rd in self.rounds for r in rd['out'] if r is not None)

    def end_to_end(self, units, seconds):
        return {'humanize_rows_per_s': self.rows() / seconds}

    def attempted(self):
        return sum(len(rd['picks']) for rd in self.rounds)

    def failed(self):
        return self.n_failed

    def work(self, units):
        B = self.t['antibodies_per_round'] * self.t['rows_per_antibody']
        fwd = units * self.width
        cfg, hl, ll = self.run.cfg, int(self.tables['heavy_len']), int(self.tables['light_len'])
        return {'model_flops': fwd * Y.model_flops(cfg, self.kind, B, hl, ll), 'f32_flops': 0.0,
                'bytenet_fwd': Y.bytenet_calls(cfg, self.kind, B, hl, ll) * fwd,
                'attention_fwd': Y.attention_calls(cfg, B) * fwd}

    def release(self):
        del self.hum
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------------
    def _row(self, inp, order, y, light_type):
        t = self.tables
        return {'x0': inp['tokens'], 'order': order, 'y': y,
                'region': np.concatenate([t['heavy_region_index'], t['light_region_index']]),
                'chain': np.asarray([t['chain_types']['H'], t['chain_types'][light_type]])}

    def check(self, control=False, mm=None):
        t = self.tables
        mask_table = np.concatenate([t['heavy_cdr_kabat_no_vernier'],
                                     t['light_cdr_kabat_no_vernier']])
        writeback = start = 0
        candidates = []
        B = self.t['antibodies_per_round'] * self.t['rows_per_antibody']
        for r_ix, rd in enumerate(self.rounds):
            first = 0           # the input's first row in the round
            for i, (pick, inp, res) in enumerate(zip(rd['picks'], rd['inputs'], rd['out'])):
                ab = self.pool[pick]
                if inp is None or res is None:
                    continue
                first += self.t['rows_per_antibody']
                start += RS.start_faults(ab['h'] + ab['l'], inp['clean'], inp['tokens'],
                                         sorted(inp['positions']), mask_table, t['tokens'],
                                         int(t['idx_pad']), int(t['idx_msk']))
                start += int(list(inp['chain']) != [t['chain_types']['H'],
                                                    t['chain_types'][ab['light_type']]])
                for j, y in enumerate(res['grids']):
                    writeback += RS.writeback_faults(inp['tokens'], inp['positions'], y)
                    candidates.append((r_ix, first - self.t['rows_per_antibody'] + j, i, j))
        rng = G.seed_sequence(self.run.seed, 4)
        n = min(self.run.cell.spec['checked_rows'], len(candidates))
        chosen = [candidates[k] for k in rng.choice(len(candidates), n, replace=False)]
        longest = max(candidates, key=lambda c: len(self.rounds[c[0]]['inputs'][c[2]]
                                                    ['positions']))
        if longest not in chosen:
            chosen[0] = longest
        rows = []
        for r_ix in sorted({c[0] for c in chosen}):
            rd = self.rounds[r_ix]
            u = RS.round_noise(rd['seed'], B, self.width, self.dev)
            for _, b, i, j in (c for c in chosen if c[0] == r_ix):
                inp = rd['inputs'][i]
                row = self._row(inp, inp['positions'], rd['out'][i]['grids'][j],
                                self.pool[rd['picks'][i]]['light_type'])
                row['u'] = u[:, b]
                rows.append(row)
        got = RS.widest_gap(R.logits_fn(self.kind, int(t['heavy_len'])), self.params,
                            self.run.cfg, rows, self.dev,
                            mm=(mm or R.fp8_round) if control else None)
        lim = self.run.cell.spec['limits']
        out = {'gap_max': (got['gap'], lim['gap_max']),
               'writeback_faults': (float(writeback), 0.0),
               'start_faults': (float(start), 0.0)}
        if control:
            out['control_gap_max'] = (got['control_gap'], lim['gap_max'])
        return out
