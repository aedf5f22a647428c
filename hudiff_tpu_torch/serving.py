"""Humanization serving: warm models on the card behind an HTTP API.

Counterpart of hudiff_tpu/serving.py. The denoisers stay resident on the
device, the kernels are built before the first request, and concurrent
requests are coalesced into shared device rounds, so a request costs its
share of a round:

    python -m hudiff_tpu_torch.serving --ab-ckpt AB.pt [--nano-ckpt NB.pt] \\
        [--port 8000] [--batch-size 16] [--positions-per-step 1] [--device cpu]

API (JSON over HTTP, stdlib http.server):
  GET  /health            -> {"status": "ok", "models": [...], "device": ...}
  GET  /metrics           -> per-endpoint counters and latency percentiles
  POST /humanize/ab       {"h_seq": .., "l_seq": .., "sample_number"?: n,
                           "method"?: "FR"|"inpaint"}
  POST /humanize/nano     {"vhh_seq": .., ...}
  POST /graft             {"h_seq": .., "l_seq": .., "back_mutation"?: bool}

One lock serializes device work (one card, one round at a time); the
ThreadingHTTPServer keeps request parsing and host prep (the pure-Python
aligner) concurrent. Each model's rounds are run by its coalescer's
worker thread. Runs on ``cuda`` unless ``device='cpu'``; without a card it
raises.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from .utils.device import resolve_device


class _Coalescer:
    """Micro-batching request coalescer for one humanizer.

    Concurrent requests enqueue their candidate rows; one worker thread
    drains the queue after a bounded arrival window and packs rows of many
    requests into shared ``device_batch``-sized rounds through
    ``humanizer.sample_rows`` (``iter_packed_chunks``, the packed path the
    dataset CLI uses). N concurrent requests with small candidate pools
    cost ceil(total_rows / device_batch) rounds instead of N.
    """

    def __init__(self, humanizer, device_lock: threading.Lock,
                 window_ms: float = 4.0):
        self.hum = humanizer
        self.lock = device_lock
        self.window = window_ms / 1000.0
        self._queue: List[dict] = []
        self._cv = threading.Condition()
        self.rounds = 0  # device rounds run
        self.max_queue_rows = 0  # high-water mark of queued candidate rows
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    @property
    def queue_rows(self) -> int:
        """Candidate rows currently waiting for a device round."""
        with self._cv:
            return sum(j['n'] for j in self._queue)

    def submit(self, inp: Dict, n_rows: int) -> np.ndarray:
        """Block until this request's ``n_rows`` sampled grids are ready."""
        job = {'inp': inp, 'n': int(n_rows), 'grids': [],
               'event': threading.Event(), 'error': None}
        with self._cv:
            self._queue.append(job)
            depth = sum(j['n'] for j in self._queue)
            self.max_queue_rows = max(self.max_queue_rows, depth)
            self._cv.notify()
        job['event'].wait()
        if job['error'] is not None:
            raise job['error']
        return np.stack(job['grids'])

    def _loop(self) -> None:
        from .sampling.humanize import _packed_pad_to, iter_packed_chunks
        while True:
            with self._cv:
                while not self._queue:
                    self._cv.wait()
            # bounded arrival window: let concurrent requests land, then
            # drain everything queued
            time.sleep(self.window)
            with self._cv:
                jobs, self._queue = self._queue, []
            stream = [(job, job['inp']) for job in jobs for _ in range(job['n'])]
            try:
                pad_to = _packed_pad_to([job['inp'] for job in jobs])
                with self.lock:
                    for chunk, out in iter_packed_chunks(self.hum, stream, pad_to):
                        self.rounds += 1
                        for (job, _), row in zip(chunk, out):
                            job['grids'].append(row)
            except Exception as e:  # noqa: BLE001 - report to waiters
                # only jobs whose rows were not all served fail: a request
                # completed in an earlier chunk keeps its result
                for job in jobs:
                    if len(job['grids']) < job['n']:
                        job['error'] = e
            for job in jobs:
                job['event'].set()


class HumanizationService:
    """Holds warm humanizers and the device lock. Usable without HTTP too."""

    def __init__(self, ab_ckpt: Optional[str] = None,
                 nano_ckpt: Optional[str] = None, batch_size: int = 16,
                 device_batch: Optional[int] = None,
                 positions_per_step: int = 1, seed: int = 2023,
                 use_bf16: bool = True, warmup: bool = True,
                 window_ms: float = 4.0, device='cuda'):
        from .sampling import humanize as H
        self.device = resolve_device(device)
        if self.device.type == 'cuda':
            # build every kernel here, not on the first round inside a
            # coalescer's worker under the device lock
            from .ops import _build
            _build.build_all()
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats: Dict[str, Dict] = {}
        self.batch_size = batch_size
        # the packed round size requests coalesce into; > batch_size means
        # several requests' candidate pools ride one device round
        device_batch = device_batch or max(4 * batch_size, batch_size)
        self.ab = self.nano = None
        self.ab_coal = self.nano_coal = None
        self.ab_finetuned = self.nano_finetuned = False
        for kind, ckpt in (('pair', ab_ckpt), ('heavy', nano_ckpt)):
            if not ckpt:
                continue
            model, finetuned = H.load_denoiser(ckpt, kind, device=self.device,
                                               use_bf16=use_bf16)
            hum = (H.PairHumanizer if kind == 'pair' else H.NanoHumanizer)(
                model, batch_size=batch_size, seed=seed, device=self.device,
                device_batch=device_batch, positions_per_step=positions_per_step)
            coal = _Coalescer(hum, self._lock, window_ms=window_ms)
            if kind == 'pair':
                self.ab, self.ab_coal, self.ab_finetuned = hum, coal, finetuned
            else:
                self.nano, self.nano_coal, self.nano_finetuned = hum, coal, finetuned
        if warmup:
            self.warmup()

    def warmup(self) -> None:
        """Run each model's first packed round at ``device_batch`` before
        traffic. It registers that batch in the batch-reuse policy
        (``iter_packed_chunks``), so later drains of the FR mode, single
        requests and bursts alike, pad to it."""
        h = ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYAMSWVRQAPGKGLEWVSAISGSGGSTYY'
             'ADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAKDRGYYFDYWGQGTLVTVSS')
        l = ('DIQMTQSPSSLSASVGDRVTITCRASQSISSYLNWYQQKPGKAPKLLIYAASSLQSGVPS'
             'RFSGSGSGTDFTLTISSLQPEDFATYYCQQSYSTPLTFGGGTKVEIK')
        from .sampling import humanize as H
        if self.ab_coal is not None:
            inp = H.pair_input(h, l, finetune=self.ab_finetuned)
            self.ab_coal.submit(inp, self.ab.device_batch)
        if self.nano_coal is not None:
            inp = H.nano_input(h, finetune=self.nano_finetuned)
            self.nano_coal.submit(inp, self.nano.device_batch)

    MAX_ROWS = 1024  # per-request bound on device work

    def _pool(self, sample_number: int, rows: Optional[int]) -> int:
        """Candidate-pool rows per request: the best-of-pool selection needs
        more than one row even for sample_number=1 (reference
        select_the_most_similarity_seq over the batch, sample.py:352-367).
        sample_number and 'rows' must be in 1..MAX_ROWS, so that one
        request cannot monopolize the device. Default pool: the service's
        batch_size, never less than sample_number."""
        if not 1 <= int(sample_number) <= self.MAX_ROWS:
            raise ValueError(
                f"'sample_number' must be between 1 and {self.MAX_ROWS}")
        if rows is None:
            return min(max(sample_number, self.batch_size), self.MAX_ROWS)
        try:
            rows = int(rows)
        except (TypeError, ValueError):
            raise ValueError("'rows' must be a positive integer") from None
        if rows < 1 or rows > self.MAX_ROWS:
            raise ValueError(f"'rows' must be between 1 and {self.MAX_ROWS}")
        return rows

    def humanize_ab(self, h_seq: str, l_seq: str, sample_number: int = 1,
                    method: str = 'FR', max_retry: int = 8,
                    rows: Optional[int] = None) -> Dict:
        if self.ab is None:
            raise ValueError('no antibody checkpoint loaded')
        from . import constants as C
        from .sampling import humanize as H
        inp = (H.pair_inpaint_input(h_seq, l_seq) if method == 'inpaint'
               else H.pair_input(h_seq, l_seq, finetune=self.ab_finetuned))
        if inp is None:
            raise ValueError('chains did not align to the IMGT grid')
        pool = self._pool(sample_number, rows)

        def round_fn():
            grids = self.ab_coal.submit(inp, pool)
            h_seqs = [H._TOK.idx2seq(g[: C.HEAVY_LEN]) for g in grids]
            l_seqs = [H._TOK.idx2seq(g[C.HEAVY_LEN:]) for g in grids]
            if sample_number > 1:
                return list(zip(h_seqs, l_seqs))
            best = H.select_most_similar(inp['clean'], grids)
            return [(h_seqs[best], l_seqs[best])]

        unique, _ = H.collect_unique(round_fn, sample_number, max_retry)
        return {'candidates': [{'h_seq': h, 'l_seq': l} for h, l in unique]}

    def humanize_nano(self, vhh_seq: str, sample_number: int = 1,
                      method: str = 'FR', max_retry: int = 8,
                      rows: Optional[int] = None) -> Dict:
        if self.nano is None:
            raise ValueError('no nanobody checkpoint loaded')
        from .numbering import align as AL
        from .sampling import humanize as H
        inp = H.nano_input(vhh_seq, finetune=self.nano_finetuned,
                           inpaint=method == 'inpaint')
        if inp is None:
            raise ValueError('sequence did not align to the IMGT grid')
        pool = self._pool(sample_number, rows)

        def round_fn():
            grids = self.nano_coal.submit(inp, pool)
            seqs = [H._TOK.idx2seq(g) for g in grids]
            # validity filter (reference nanosample.py:338-353)
            aligned = AL.align_to_aho_batch(seqs, 'H')
            valid = [k for k, a in enumerate(aligned) if a is not None]
            if not valid:
                return None
            if sample_number > 1:
                return [seqs[k] for k in valid]
            best = H.select_most_similar(inp['clean'], grids[valid])
            return [seqs[valid[best]]]

        unique, failed = H.collect_unique(round_fn, sample_number, max_retry)
        if failed and not unique:
            raise ValueError('no valid candidates sampled')
        return {'candidates': [{'vhh_seq': s} for s in unique]}

    def graft(self, h_seq: str, l_seq: str,
              back_mutation: bool = False) -> Dict:
        from .numbering import germline as G
        h, l = G.cdr_pair_grafting(h_seq, l_seq, back_mutation=back_mutation)
        return {'h_seq': h, 'l_seq': l}

    def health(self) -> Dict:
        models = ([] + (['ab'] if self.ab else [])
                  + (['nano'] if self.nano else []))
        rounds = {name: coal.rounds for name, coal in
                  (('ab', self.ab_coal), ('nano', self.nano_coal))
                  if coal is not None}
        name = (torch.cuda.get_device_name(self.device) if self.device.type == 'cuda'
                else self.device.type)
        return {'status': 'ok', 'models': models, 'device': str(self.device),
                'device_name': name, 'device_rounds': rounds}

    # latency samples kept per endpoint for percentile estimation; a fixed
    # window bounds memory and keeps the percentiles recency-weighted
    LATENCY_WINDOW = 2048

    def record_request(self, endpoint: str, seconds: float,
                       ok: bool) -> None:
        with self._stats_lock:
            s = self._stats.setdefault(
                endpoint, {'count': 0, 'errors': 0, 'total_sec': 0.0,
                           'max_sec': 0.0,
                           'recent': deque(maxlen=self.LATENCY_WINDOW)})
            s['count'] += 1
            if not ok:
                s['errors'] += 1
            s['total_sec'] += seconds
            s['max_sec'] = max(s['max_sec'], seconds)
            s['recent'].append(seconds)

    def metrics(self) -> Dict:
        """Per-endpoint request counters and latency percentiles (p50/p95/p99
        over the last ``LATENCY_WINDOW`` requests), coalescer queue depth
        and device-round totals (GET /metrics)."""
        with self._stats_lock:
            out = {}
            for ep, s in self._stats.items():
                row = {
                    'count': s['count'], 'errors': s['errors'],
                    'mean_sec': round(s['total_sec'] / max(s['count'], 1), 4),
                    'max_sec': round(s['max_sec'], 4),
                }
                if s['recent']:
                    lat = np.asarray(s['recent'], np.float64)
                    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
                    row.update(p50_sec=round(float(p50), 4),
                               p95_sec=round(float(p95), 4),
                               p99_sec=round(float(p99), 4))
                out[ep] = row
        coalescers = {name: {'rounds': coal.rounds,
                             'queue_rows': coal.queue_rows,
                             'max_queue_rows': coal.max_queue_rows}
                      for name, coal in (('ab', self.ab_coal),
                                         ('nano', self.nano_coal))
                      if coal is not None}
        rounds = {name: c['rounds'] for name, c in coalescers.items()}
        return {'endpoints': out, 'device_rounds': rounds,
                'coalescers': coalescers}


def make_handler(service: HumanizationService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _reply(self, code: int, payload: Dict) -> None:
            self._last_code = code
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/health':
                self._reply(200, service.health())
            elif self.path == '/metrics':
                self._reply(200, service.metrics())
            else:
                self._reply(404, {'error': f'unknown path {self.path}'})

        def do_POST(self):
            t0 = time.monotonic()
            ok = False
            try:
                self._do_post_inner()
                ok = 200 <= getattr(self, '_last_code', 500) < 300
            finally:
                service.record_request(self.path, time.monotonic() - t0, ok)

        def _do_post_inner(self):
            try:
                n = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(n) or b'{}')
            except (ValueError, json.JSONDecodeError) as e:
                return self._reply(400, {'error': f'bad JSON: {e}'})
            if not isinstance(req, dict):
                return self._reply(
                    400, {'error': 'JSON body must be an object'})

            def as_int(name, default):
                # int() on a list raises TypeError: a client 400/422, not a
                # handler crash
                try:
                    return int(req.get(name, default))
                except (TypeError, ValueError):
                    raise ValueError(
                        f"'{name}' must be an integer") from None

            def as_str(name):
                # non-string sequence fields are a client error caught here,
                # at the boundary, not by a blanket TypeError catch that
                # would turn server faults into 422s
                v = req[name]
                if not isinstance(v, str):
                    raise ValueError(f"'{name}' must be a string")
                return v

            try:
                if self.path == '/humanize/ab':
                    out = service.humanize_ab(
                        as_str('h_seq'), as_str('l_seq'),
                        sample_number=as_int('sample_number', 1),
                        method=req.get('method', 'FR'),
                        rows=req.get('rows'))
                elif self.path == '/humanize/nano':
                    out = service.humanize_nano(
                        as_str('vhh_seq'),
                        sample_number=as_int('sample_number', 1),
                        method=req.get('method', 'FR'),
                        rows=req.get('rows'))
                elif self.path == '/graft':
                    out = service.graft(
                        as_str('h_seq'), as_str('l_seq'),
                        back_mutation=bool(req.get('back_mutation', False)))
                else:
                    return self._reply(404,
                                       {'error': f'unknown path {self.path}'})
            except KeyError as e:
                return self._reply(400, {'error': f'missing field {e}'})
            except ValueError as e:
                return self._reply(422, {'error': str(e)})
            self._reply(200, out)

    return Handler


class _Server(ThreadingHTTPServer):
    """ThreadingHTTPServer with a listen backlog sized for a burst of
    clients. socketserver's default backlog of 5 overflows when more
    clients connect at once than the accept loop takes in (it competes for
    the GIL with the coalescers' sampling loops), and the connections past
    it are reset or retried a second later."""
    request_queue_size = 128


def serve(service: HumanizationService, host: str = '127.0.0.1',
          port: int = 8000) -> ThreadingHTTPServer:
    """Create (but do not start) the HTTP server; call serve_forever() or
    run it from a thread. port=0 picks an ephemeral port."""
    return _Server((host, port), make_handler(service))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--ab-ckpt', default=None, help='pair-kind port checkpoint (.pt)')
    p.add_argument('--nano-ckpt', default=None, help='heavy-kind port checkpoint (.pt)')
    p.add_argument('--host', default='127.0.0.1')
    p.add_argument('--port', type=int, default=8000)
    p.add_argument('--batch-size', type=int, default=16,
                   help='default per-request candidate pool')
    p.add_argument('--device-batch', type=int, default=None,
                   help='packed round size concurrent requests coalesce '
                        'into (default 4x batch-size)')
    p.add_argument('--window-ms', type=float, default=4.0,
                   help='arrival window for request coalescing')
    p.add_argument('--positions-per-step', type=int, default=1)
    p.add_argument('--seed', type=int, default=2023)
    p.add_argument('--fp32', action='store_true')
    p.add_argument('--no-warmup', action='store_true')
    p.add_argument('--device', default='cuda',
                   help="torch device; 'cpu' runs the plain versions of the kernels")
    args = p.parse_args(argv)
    if not args.ab_ckpt and not args.nano_ckpt:
        p.error('need --ab-ckpt and/or --nano-ckpt')
    service = HumanizationService(
        args.ab_ckpt, args.nano_ckpt, batch_size=args.batch_size,
        device_batch=args.device_batch, window_ms=args.window_ms,
        positions_per_step=args.positions_per_step, seed=args.seed,
        use_bf16=not args.fp32, warmup=not args.no_warmup, device=args.device)
    srv = serve(service, args.host, args.port)
    print(f'serving on http://{srv.server_address[0]}:{srv.server_address[1]}'
          f' (models: {service.health()["models"]})')
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return srv


if __name__ == '__main__':
    main()
