"""One nanobody humanized per request, in a closed loop of one client (the
``humanize nano --vhh-seq`` path, repeated).

Traffic parameters (``traffic/<mix>.json``): ``parents`` (a data file of
parent VHHs with their CDRs), ``pool`` (nanobodies made at set-up, framework
mutants with ``mutations`` substitutions, kept only if ``nano_input`` numbers
them), ``rows`` (``--batch-size``), ``max_retry``, ``finetune_mask`` and
``sample_order``. The compute type is the configuration's ``dtype``.

A unit is one request: ``NanoHumanizer.__call__`` on the next nanobody,
its generator seeded from the run's seed and the request's index (one CLI
invocation per nanobody), timed from the sequence handed in to the result:
host prep, every round, the validity filter and its retries. The orders
are the CLI's ``--sample-order sequential`` (the masked slots left to
right), which the reference can follow without the program's order
generator.

The check, once the window has closed, of every request: its start
(``nano_input`` again on the host), the write-back of every served
candidate, and the filter (``reference.sampling.filter_faults``): a sound
round's 16 candidates all pass the filter's rule, so a request served in
one round holds all 16, each one the rule keeps, its best the most similar
to the parent; the filter's own clock (``filter_s``) moved in every
request. Then the widest gap of a sample of the requests against the
float32 reference. A request that returns nothing counts all its rows as
filter faults.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generate as G
from benchmark import weights
from benchmark import yardstick as Y
from benchmark.harness import log
from benchmark.reference import denoiser as R
from benchmark.reference import sampling as RS

from hudiff_tpu_torch.models.denoiser import DenoiserConfig, NanoAntiTFNet
from hudiff_tpu_torch.sampling import humanize as HZ

class Driver:
    kind = 'heavy'

    def __init__(self, run):
        self.run, self.t = run, run.traffic
        self.dev = run.device
        self.tables = G.imgt()
        self.requests = []
        self.n_failed = 0
        self._nano_input = None

    def setup(self):
        cfg = DenoiserConfig.from_dict(self.run.cfg)
        model = NanoAntiTFNet(cfg, dtype=getattr(torch, self.run.cfg['dtype']), device=self.dev)
        shapes = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
        self.params = weights.make(shapes, self.run.seed, self.dev)
        model.load_state_dict(self.params)
        self.run.mark('model')
        rng = G.seed_sequence(self.run.seed, 1)
        parents = G.load_data(self.t['parents'])['chains']
        self.pool, tries = [], 0
        while len(self.pool) < self.t['pool']:
            tries += 1
            if tries > 8 * self.t['pool']:
                raise RuntimeError('too few framework mutants number as nanobodies')
            p = parents[len(self.pool) % len(parents)]
            seq = G.framework_mutant(p['seq'], p['cdrs'], self.t['mutations'], rng)
            if HZ.nano_input(seq, finetune=self.t['finetune_mask']) is not None:
                self.pool.append(seq)
        self.hum = HZ.NanoHumanizer(model, batch_size=self.t['rows'],
                                    shuffle=self.t['sample_order'] == 'shuffle',
                                    seed=self.run.seed, device=self.dev,
                                    device_batch=self.t['rows'])
        self.run.mark('pool')
        self.picks = G.seed_sequence(self.run.seed, 2)
        if self.run.tracing:         # a harness span around the host prep
            self._nano_input = HZ.nano_input

            def nano_input(*args, **kwargs):
                with self.run.span('nano_input'):
                    return self._nano_input(*args, **kwargs)
            HZ.nano_input = nano_input
        for _ in range(2):           # captures the round's graph
            self.unit()
        self.requests.clear()
        self.n_failed = 0

    def unit(self):
        seq = self.pool[int(self.picks.integers(len(self.pool)))]
        seed = int(G.seed_sequence(self.run.seed, 3, len(self.requests)).integers(2 ** 62))
        self.hum.generator.manual_seed(seed)
        filt = self.hum.filter_s
        t0 = time.perf_counter()
        try:
            with self.run.span('request'):
                res = self.hum(seq, finetune=self.t['finetune_mask'],
                               max_retry=self.t['max_retry'])
        except Exception as e:  # noqa: BLE001 - a request that raises is a failed request
            log(f'request raised {type(e).__name__}: {e}')
            res = None
        latency = time.perf_counter() - t0
        self.n_failed += res is None
        filter_s = self.hum.filter_s - filt
        if self.run.counting:
            self.run.spans.setdefault('filter', []).append(filter_s)
        self.requests.append({'seq': seq, 'seed': seed, 'res': res, 'latency': latency,
                              'filter_s': filter_s})

    def settle(self):
        if self.dev.type == 'cuda':
            torch.cuda.synchronize(self.dev)

    def end_to_end(self, units, seconds):
        ms = np.asarray([r['latency'] for r in self.requests]) * 1e3
        return {'request_p50_ms': float(np.percentile(ms, 50)),
                'request_p95_ms': float(np.percentile(ms, 95))}

    def attempted(self):
        return len(self.requests)

    def failed(self):
        return self.n_failed

    def _width(self, inp) -> int:
        return G.bucket_width(len(inp['positions']), inp['pad_to'])

    def work(self, units):
        # one round a request: a sound round's candidates all pass the
        # filter, and the check holds each request to that
        fwd = 0
        for req in self.requests[-units:]:
            fwd += self._width(HZ.nano_input(req['seq'], finetune=self.t['finetune_mask']))
        B, cfg, hl = self.t['rows'], self.run.cfg, int(self.tables['heavy_len'])
        return {'model_flops': fwd * Y.model_flops(cfg, self.kind, B, hl, 0), 'f32_flops': 0.0,
                'bytenet_fwd': Y.bytenet_calls(cfg, self.kind, B, hl, 0) * fwd,
                'attention_fwd': Y.attention_calls(cfg, B) * fwd}

    def release(self):
        if self._nano_input is not None:
            HZ.nano_input = self._nano_input
        del self.hum
        if self.dev.type == 'cuda':
            torch.cuda.empty_cache()

    def check(self, control=False, mm=None):
        t = self.tables
        pad, rows_n = int(t['idx_pad']), self.t['rows']
        writeback = start = filt = 0
        full = []
        for q, req in enumerate(self.requests):
            inp = HZ.nano_input(req['seq'], finetune=self.t['finetune_mask'])
            start += RS.start_faults(req['seq'], inp['clean'], inp['tokens'], inp['positions'],
                                     t['heavy_cdr_kabat_no_vernier'], t['tokens'], pad,
                                     int(t['idx_msk']))
            filt += int(not req['filter_s'] > 0)
            if req['res'] is None:
                filt += rows_n
                continue
            filt += RS.filter_faults(inp['clean'], req['res'], rows_n, t['tokens'], pad,
                                     int(t['n_aa']))
            for y in req['res']['grids']:
                writeback += RS.writeback_faults(inp['tokens'], inp['positions'], y)
            if len(req['res']['grids']) == rows_n:
                full.append((q, inp))
        rng = G.seed_sequence(self.run.seed, 4)
        n = min(self.run.cell.spec['checked_requests'], len(full))
        rows = []
        for k in sorted(rng.choice(len(full), n, replace=False)):
            q, inp = full[k]
            req, width = self.requests[q], self._width(inp)
            u = RS.round_noise(req['seed'], self.t['rows'], width, self.dev)
            for b in sorted({0, int(rng.integers(1, self.t['rows']))}):
                rows.append({'x0': inp['tokens'], 'order': inp['positions'],
                             'y': req['res']['grids'][b], 'region': t['heavy_region_index'],
                             'chain': None, 'u': u[:, b]})
        lim = self.run.cell.spec['limits']
        out = {'writeback_faults': (float(writeback), 0.0), 'start_faults': (float(start), 0.0),
               'filter_faults': (float(filt), 0.0), 'no_request_checked': (float(n == 0), 0.0)}
        if rows:
            got = RS.widest_gap(R.logits_fn(self.kind, int(t['heavy_len'])), self.params,
                                self.run.cfg, rows, self.dev,
                                mm=(mm or R.fp8_round) if control else None)
            out['gap_max'] = (got['gap'], lim['gap_max'])
            if control:
                out['control_gap_max'] = (got['control_gap'], lim['gap_max'])
        return out
