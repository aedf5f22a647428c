"""The port's humanization service (hudiff_tpu_torch/serving.py) on the CPU:
every test of tests/test_serving.py with the same bounds, plus a nanobody
and an inpaint request, ``/graft`` against the JAX package's
``cdr_pair_grafting``, the device in ``health()`` and the refusal to start
without a card when none is asked for.

The services run in f32 with ``device='cpu'``, where the kernels run their
plain versions. The Ab model is ``DenoiserConfig().test_size()`` narrowed
to one 64-wide attention of two heads and a 64-wide FFN (random weights
from a seed; a round of 185 forwards at B = 8 takes ~10 s here, against
~45 s at the test size's 512-wide attention). Its candidates are random
frameworks, so their CDRs are found on the parental grid, not by
realigning them. The nanobody model is the in-repo demo checkpoint
examples/demo_nb_tiny (trained), whose candidates pass the validity filter.
"""
import dataclasses
import os
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from hudiff_tpu.numbering import germline as JG
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch import serving as SV
from hudiff_tpu_torch.models.denoiser import AntiTFNet, DenoiserConfig
from hudiff_tpu_torch.numbering import regions as R
from hudiff_tpu_torch.sampling import humanize as H
from hudiff_tpu_torch.training import checkpoints as CK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
VHH = ('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADSVKGRF'
       'TISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several xdist workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def ckpts(tmp_path_factory):
    import jax
    from hudiff_tpu.models.denoiser import nano_config as j_nano_config
    from hudiff_tpu.training.checkpoints import restore
    tmp = tmp_path_factory.mktemp('serve')
    torch.manual_seed(0)
    cfg = dataclasses.replace(DenoiserConfig().test_size(), att_model=64, nhead=2,
                              dim_feedforward=64)
    ab = CK.save(str(tmp / 'ab.pt'), AntiTFNet(cfg), cfg)
    restored = restore(os.path.join(REPO, 'examples', 'demo_nb_tiny'))
    ncfg = DenoiserConfig(**j_nano_config().from_dict(
        restored['meta']['config']['model']).__dict__)
    tree = jax.tree_util.tree_map(np.asarray, restored['payload']['params'])
    nano = CK.save(str(tmp / 'nano.pt'), CK.from_flax_params(tree, ncfg, device='cpu'), ncfg)
    return ab, nano


def _start(service):
    srv = SV.serve(service, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f'http://127.0.0.1:{srv.server_address[1]}'


@pytest.fixture(scope='module')
def serve_ctx(ckpts):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    service = SV.HumanizationService(ab_ckpt=ckpts[0], batch_size=2, device_batch=8,
                                     use_bf16=False, warmup=True, window_ms=150.0,
                                     device='cpu')
    torch.set_num_threads(n)
    srv, url = _start(service)
    yield url, service
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope='module')
def server(serve_ctx):
    return serve_ctx[0]


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def test_health(server):
    out = _get(server + '/health')
    assert out['status'] == 'ok'
    assert out['models'] == ['ab']
    assert out['device'] == 'cpu' and out['device_name'] == 'cpu'
    assert out['device_rounds']['ab'] >= 1   # the warm-up round


def test_humanize_ab(server):
    code, out = _post(server + '/humanize/ab',
                      {'h_seq': H1, 'l_seq': L1, 'sample_number': 2})
    assert code == 200
    assert len(out['candidates']) == 2
    for c in out['candidates']:
        assert set(c) == {'h_seq', 'l_seq'}
        assert len(c['h_seq']) > 80


def _cdr_strings(grid):
    """Each CDR's residues (pads dropped) from a parental 291 grid, by chain."""
    ids = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX])
    out = {'h_seq': [], 'l_seq': []}
    for chain, sl in (('h_seq', slice(0, C.HEAVY_LEN)), ('l_seq', slice(C.HEAVY_LEN, None))):
        for k in np.unique(ids[sl][ids[sl] != 0]):
            out[chain].append(''.join(C.TOKENS[t] for t in grid[sl][ids[sl] == k]
                                      if t != C.IDX_PAD))
    return out


def test_humanize_ab_inpaint_keeps_cdrs(server):
    code, out = _post(server + '/humanize/ab',
                      {'h_seq': H1, 'l_seq': L1, 'method': 'inpaint', 'sample_number': 2})
    assert code == 200 and len(out['candidates']) == 2
    cdrs = _cdr_strings(H.pair_inpaint_input(H1, L1)['clean'])
    for c in out['candidates']:
        for chain, strings in cdrs.items():
            rest = c[chain]
            for cdr in strings:               # each CDR, in order
                assert cdr in rest, (chain, cdr)
                rest = rest[rest.index(cdr) + len(cdr):]


def test_graft_endpoint(server):
    for back in (True, False):
        code, out = _post(server + '/graft',
                          {'h_seq': H1, 'l_seq': L1, 'back_mutation': back})
        assert code == 200
        assert (out['h_seq'], out['l_seq']) == JG.cdr_pair_grafting(
            H1, L1, back_mutation=back)


def test_missing_field_400(server):
    code, out = _post(server + '/humanize/ab', {'h_seq': H1})
    assert code == 400 and 'missing field' in out['error']


def test_non_dict_body_400(server):
    """A valid-JSON non-object body must get a 400, not a dropped socket."""
    for payload in ([1, 2], 'a string'):
        code, out = _post(server + '/humanize/ab', payload)
        assert code == 400 and 'object' in out['error']


def test_unaligned_422(server):
    code, out = _post(server + '/humanize/ab',
                      {'h_seq': 'AAAA', 'l_seq': 'GGGG'})
    assert code == 422


def test_no_nano_model_422(server):
    code, out = _post(server + '/humanize/nano', {'vhh_seq': H1})
    assert code == 422 and 'no nanobody checkpoint' in out['error']


def test_unknown_path_404(server):
    code, out = _post(server + '/frobnicate', {})
    assert code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server + '/frobnicate')
    assert e.value.code == 404


def test_concurrent_requests(server):
    """Device access serializes behind the lock; concurrent requests all
    complete and return well-formed candidates."""
    results = []

    def call():
        results.append(_post(server + '/humanize/ab',
                             {'h_seq': H1, 'l_seq': L1}))

    threads = [threading.Thread(target=call) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(results) == 3
    assert all(code == 200 and len(out['candidates']) == 1
               for code, out in results)


def test_a_burst_of_connections_is_served(server):
    """More clients than socketserver's default listen backlog (5) connect
    at once, released together from a barrier while other threads hold
    the GIL, as the coalescers' sampling loops do: none is reset, every
    POST gets its reply (404 for a path the service does not have)."""
    n = 64
    ready = threading.Barrier(n + 1)
    out, stop = [None] * n, threading.Event()

    def call(i):
        ready.wait(60)
        try:
            out[i] = _post(server + '/no-such-path', {'h_seq': H1})[0]
        except OSError as e:
            out[i] = repr(e)

    def busy():
        while not stop.is_set():
            sum(range(10000))

    hogs = [threading.Thread(target=busy) for _ in range(3)]
    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in hogs + threads:
        t.start()
    ready.wait(60)
    for t in threads:
        t.join()
    stop.set()
    for t in hogs:
        t.join()
    assert out == [404] * n


def test_request_coalescing(serve_ctx):
    """N concurrent single-candidate requests coalesce into ~1 packed device
    round, not N rounds (device_batch 8, 150 ms arrival window)."""
    _, service = serve_ctx
    rounds_before = service.ab_coal.rounds
    n = 6
    outs = [None] * n

    def call(i):
        outs[i] = service.humanize_ab(H1, L1, sample_number=1, rows=1)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(o is not None and len(o['candidates']) == 1 for o in outs)
    # 6 requests x 1 row = 6 rows <= device_batch 8 -> one shared round
    # (2 if a thread lands after the first window closes)
    assert service.ab_coal.rounds - rounds_before <= 2


def test_metrics_endpoint(server):
    """GET /metrics reports per-endpoint counters and device rounds."""
    _post(server + '/humanize/ab', {'h_seq': H1, 'l_seq': L1})
    _post(server + '/humanize/ab', {'h_seq': 'AAAA', 'l_seq': 'GG'})  # 422
    m = _get(server + '/metrics')
    ep = m['endpoints']['/humanize/ab']
    assert ep['count'] >= 2 and ep['errors'] >= 1
    assert ep['mean_sec'] > 0 and ep['max_sec'] >= ep['mean_sec']
    assert m['device_rounds']['ab'] >= 1
    assert 0 < ep['p50_sec'] <= ep['p95_sec'] <= ep['p99_sec']
    assert ep['p99_sec'] <= ep['max_sec'] + 1e-4
    coal = m['coalescers']['ab']
    assert coal['rounds'] >= 1
    assert coal['queue_rows'] >= 0
    assert coal['max_queue_rows'] >= 1


def test_coalescer_tail_latency_bound():
    """Under a burst of N concurrent requests, per-request latency is bounded
    by the arrival window plus the shared device round(s), not N rounds:
    with round_cost=100ms and 32 requests, per-request rounds would put the
    last request at ~3.2s."""
    import time as _time

    ROUND_COST = 0.1

    class StubHum:
        device_batch = 64

        def sample_rows(self, rows, pad_to, batch=None):
            _time.sleep(ROUND_COST)
            return np.zeros((len(rows), 4), np.int32)

    coal = SV._Coalescer(StubHum(), threading.Lock(), window_ms=50.0)
    inp = {'positions': np.arange(3), 'pad_to': 8}
    n = 32
    lat = [None] * n
    # every thread is spawned and waiting before any submit, so thread-start
    # jitter cannot straggle arrivals past the window
    ready = threading.Barrier(n)

    def call(i):
        ready.wait(10)
        t0 = _time.monotonic()
        coal.submit(inp, 1)
        lat[i] = _time.monotonic() - t0

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert all(v is not None for v in lat)
    assert max(lat) < 1.0, f'tail latency {max(lat):.3f}s exceeds bound'
    assert coal.rounds <= 2
    assert coal.max_queue_rows >= n // 2  # the burst actually queued
    assert coal.queue_rows == 0  # drained


def test_sample_number_bounds_422(server):
    """An absurd sample_number is a 422, not a device-monopolizing pool."""
    code, out = _post(server + '/humanize/ab',
                      {'h_seq': H1, 'l_seq': L1, 'sample_number': 10**8})
    assert code == 422 and 'sample_number' in out['error']
    code, out = _post(server + '/humanize/ab',
                      {'h_seq': H1, 'l_seq': L1, 'sample_number': 0})
    assert code == 422


def test_non_string_sequence_422(server):
    """Non-string sequence fields give a clean 422 on every endpoint."""
    code, _ = _post(server + '/humanize/ab', {'h_seq': 123, 'l_seq': None})
    assert code == 422
    code, _ = _post(server + '/graft', {'h_seq': 123, 'l_seq': L1})
    assert code == 422
    code, _ = _post(server + '/humanize/ab', {'h_seq': H1, 'l_seq': L1,
                                              'sample_number': [1]})
    assert code == 422


def test_pool_respects_batch_size():
    """The default candidate pool is the configured batch_size, never below
    sample_number; both counts are bounded."""
    svc = SV.HumanizationService.__new__(SV.HumanizationService)
    svc.batch_size = 64
    assert svc._pool(1, None) == 64
    assert svc._pool(100, None) == 100  # never below sample_number
    assert svc._pool(1, 32) == 32
    with pytest.raises(ValueError):
        svc._pool(0, None)
    with pytest.raises(ValueError):
        svc._pool(1, 4096)
    with pytest.raises(ValueError):
        svc._pool(10**8, None)
    with pytest.raises(ValueError):
        svc._pool(1, 'many')


def test_coalescer_partial_failure_isolation():
    """A failing chunk fails only the jobs whose rows were not all served:
    a request completed in an earlier chunk keeps its result, and the
    other one gets the worker's exception."""

    class Boom(Exception):
        pass

    class StubHum:
        device_batch = 2

        def __init__(self):
            self.calls = 0

        def sample_rows(self, rows, pad_to, batch=None):
            self.calls += 1
            if self.calls > 1:
                raise Boom('chunk 2 exploded')
            return np.zeros((len(rows), 4), np.int32)

    coal = SV._Coalescer(StubHum(), threading.Lock(), window_ms=200.0)
    inp = {'positions': np.arange(3), 'pad_to': 8}
    results = {}

    def run(name, n):
        try:
            results[name] = coal.submit(inp, n)
        except Exception as e:  # noqa: BLE001
            results[name] = e

    ta = threading.Thread(target=run, args=('a', 2))
    tb = threading.Thread(target=run, args=('b', 2))
    ta.start(); tb.start(); ta.join(10); tb.join(10)
    vals = list(results.values())
    oks = [v for v in vals if isinstance(v, np.ndarray)]
    errs = [v for v in vals if isinstance(v, Exception)]
    assert len(oks) == 1 and len(errs) == 1
    assert oks[0].shape == (2, 4) and isinstance(errs[0], Boom)


def test_nano_and_ab_service(ckpts):
    """A service with both models and k = 2 positions per step: nanobody
    requests (validity-filtered candidates whose realigned CDRs are the
    parent's) and an inpaint Ab request sharing the device lock; health
    names both models."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    service = SV.HumanizationService(ab_ckpt=ckpts[0], nano_ckpt=ckpts[1], batch_size=4,
                                     device_batch=8, positions_per_step=2, use_bf16=False,
                                     warmup=False, window_ms=20.0, device='cpu')
    torch.set_num_threads(n)
    srv, url = _start(service)
    try:
        assert _get(url + '/health')['models'] == ['ab', 'nano']
        code, out = _post(url + '/humanize/nano', {'vhh_seq': VHH, 'sample_number': 2})
        assert code == 200 and 1 <= len(out['candidates']) <= 2
        cdrs = [R.region_sequences(VHH, True, 'VHH')[k] for k in ('cdr1', 'cdr2', 'cdr3')]
        for c in out['candidates']:
            got = R.region_sequences(c['vhh_seq'], True, 'VHH')
            assert [got[k] for k in ('cdr1', 'cdr2', 'cdr3')] == cdrs
        code, out = _post(url + '/humanize/nano', {'vhh_seq': L1})
        assert code == 422
        code, out = _post(url + '/humanize/ab', {'h_seq': H1, 'l_seq': L1,
                                                 'method': 'inpaint'})
        assert code == 200 and len(out['candidates']) == 1
        assert service.nano_coal.rounds >= 1 and service.ab_coal.rounds == 1
    finally:
        srv.shutdown()
        srv.server_close()


def test_service_refuses_cuda_without_a_card(ckpts):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        SV.HumanizationService()
    with pytest.raises(RuntimeError, match='CUDA'):
        SV.HumanizationService(ab_ckpt=ckpts[0], warmup=False)


def test_main_needs_a_checkpoint():
    with pytest.raises(SystemExit):
        SV.main(['--device', 'cpu'])
