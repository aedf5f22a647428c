"""The port's tracer (``hudiff_tpu_torch.utils.tracing``) and the spans the
humanizers, the training steps and the Nb fine-tune loss open, on the
CPU: off by default, on under a profiler session and off after it, parents
and units, the humanizers' spans in order, the ``rounds`` counter, the Nb
fine-tune step's ``step`` / ``scorer`` / ``scorer.backward``, device spans'
events resolved as the stream passes them, ``gc`` and ``pretrain
--profile``'s ``spans.json``."""
import gc
import json
import os
import time

import numpy as np
import pytest
import torch

from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.models import abnativ as AB
from hudiff_tpu_torch.models import finetune as F
from hudiff_tpu_torch.models.denoiser import NanoAntiTFNet, nano_config
from hudiff_tpu_torch.sampling import humanize as H
from hudiff_tpu_torch.training import finetune as FT
from hudiff_tpu_torch.training import pretrain as PT
from hudiff_tpu_torch.training import train_step as T
from hudiff_tpu_torch.utils import tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
VHH = ('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADSVKGRF'
       'TISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')
SMOKE = dict(d_embedding=32, kernel=4, stride=2, num_heads=2, num_mha_layers=1, d_ff=64,
             num_embeddings=16, embedding_dim_code_book=8)


@pytest.fixture(autouse=True)
def _fresh_tracer():
    """Each test starts with the buffer empty, and leaves it so."""
    tracing.reset()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tracing.reset()
    torch.set_num_threads(n)


def _profiled():
    """A profiler session of the host alone: tracing is on inside it."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


class _Peaked(torch.nn.Module):
    """A denoiser stub whose logits pick the grid ``target`` at every slot,
    so that every sampled row is the target's (a real chain, which the
    nanobody filter keeps)."""

    def __init__(self, target):
        super().__init__()
        self.target = torch.as_tensor(target, dtype=torch.long)

    def forward(self, tokens, region, chain=None):
        tgt = self.target.to(tokens.device).expand(tokens.shape[0], -1)
        return 1e4 * torch.nn.functional.one_hot(tgt, C.N_TOKENS).float()


def _spans(names_only=False):
    out = [r for r in tracing.records() if r['kind'] == 'span' and r['name'] != 'gc']
    return [r['name'] for r in out] if names_only else out


def _counts(name):
    return sum(r['n'] for r in tracing.records() if r['kind'] == 'count' and r['name'] == name)


def test_off_by_default_records_nothing(monkeypatch):
    def no_event(*args, **kwargs):
        raise AssertionError('a CUDA event was built with tracing off')
    monkeypatch.setattr(torch.cuda, 'Event', no_event)
    assert not tracing.on()

    @tracing.span('decorated', device=True)
    def work():
        return 3
    with tracing.span('plain'), tracing.span('device', device=True):
        tracing.count('rounds', 5)
        assert work() == 3
    assert tracing.records() == [] and _counts('rounds') == 0
    assert tracing.span('plain') is tracing.span('plain')     # one shared no-op a name
    assert tracing._on_gc not in gc.callbacks


@pytest.mark.parametrize('how', ['profiler', 'autograd_profiler'])
def test_on_under_a_profiler_or_enable_and_off_after(how):
    """Either profiler API turns tracing on for its session, and only then."""
    session = _profiled() if how == 'profiler' else torch.autograd.profiler.profile()
    with session:
        assert tracing.on()
        with tracing.span('inside'):
            tracing.count('rounds')
        assert tracing._on_gc in gc.callbacks
    assert not tracing.on()
    with tracing.span('after'):
        tracing.count('rounds')
    assert _spans(names_only=True) == ['inside'] and _counts('rounds') == 1
    assert tracing._on_gc not in gc.callbacks


def test_parents_units_and_self_time():
    with _profiled():
        with tracing.span('outer'):
            time.sleep(0.02)
            with tracing.span('first'):
                time.sleep(0.01)
            with tracing.span('second'):
                with tracing.span('leaf'):
                    time.sleep(0.01)
        with tracing.span('next'):
            pass
    spans = {s['name']: s for s in _spans()}
    outer = spans['outer']
    assert [s['name'] for s in _spans()] == ['outer', 'first', 'second', 'leaf', 'next']
    assert outer['parent'] is None and outer['unit'] == outer['id']
    assert spans['first']['parent'] == spans['second']['parent'] == outer['id']
    assert spans['leaf']['parent'] == spans['second']['id']
    assert {spans[n]['unit'] for n in ('first', 'second', 'leaf')} == {outer['id']}
    assert spans['next']['unit'] == spans['next']['id'] != outer['id']

    def dur(s):
        return s['end_ns'] - s['start_ns']
    for child in ('first', 'second', 'leaf'):
        parent = next(s for s in _spans() if s['id'] == spans[child]['parent'])
        assert parent['start_ns'] <= spans[child]['start_ns'] <= spans[child]['end_ns'] \
            <= parent['end_ns']
    own = dur(outer) - dur(spans['first']) - dur(spans['second'])
    assert 0.02e9 <= own < dur(outer) - 0.02e9        # the outer sleep, not the children's
    assert dur(spans['second']) - dur(spans['leaf']) < 0.01e9


def _pair_humanizer():
    target = H.pair_input(H1, L1)['clean']
    return H.PairHumanizer(_Peaked(target), batch_size=2, device_batch=4, seed=3,
                           device='cpu')


def _nano_humanizer():
    return H.NanoHumanizer(_Peaked(H.nano_input(VHH)['clean']), batch_size=2, seed=3,
                           device='cpu')


@pytest.mark.parametrize('path', ['pair_humanize_many', 'nano_call'])
def test_humanizers_record_their_spans_in_order(path):
    if path == 'pair_humanize_many':
        hum = _pair_humanizer()
        with _profiled():
            inputs = [H.pair_input(H1, L1), H.pair_input(H1, L1)]
            out = hum.humanize_many(inputs, rows_per_input=2)
        want = ['pair_input', 'pair_input', 'round.prep', 'result', 'result']
    else:
        hum = _nano_humanizer()
        with _profiled():
            out = [hum(VHH)]
        want = ['humanize', 'nano_input', 'round.prep', 'filter']
    assert all(r is not None for r in out)
    spans = _spans()
    assert [s['name'] for s in spans] == want
    assert all(s['drained_in'] is True for s in spans)     # nothing queued without CUDA
    assert _counts('rounds') == 1
    if path == 'pair_humanize_many':    # no request span: each span is its own unit
        assert all(s['parent'] is None and s['unit'] == s['id'] for s in spans)
        return
    unit = spans[0]['id']
    assert all(s['unit'] == unit for s in spans)
    assert all(s['parent'] == unit for s in spans[1:])
    assert [r['unit'] for r in tracing.records() if r['kind'] == 'count'] == [unit]


def test_a_filter_rejection_sends_a_round_back(monkeypatch):
    hum = _nano_humanizer()
    real, calls = H._nano_result, []

    def reject_first(inp, out):
        calls.append(1)
        return None if len(calls) == 1 else real(inp, out)
    monkeypatch.setattr(H, '_nano_result', reject_first)
    with _profiled():
        assert hum(VHH, max_retry=3) is not None
    assert _counts('rounds') == 2
    assert _spans(names_only=True) == ['humanize', 'nano_input', 'round.prep', 'filter',
                                       'round.prep', 'filter']


def test_nano_finetune_step_records_step_and_its_scorers():
    torch.manual_seed(0)
    model = NanoAntiTFNet(nano_config().test_size(), device='cpu').eval()
    scorers = [AB.frozen(AB.AbNatiVModel(AB.AbNatiVParams(**SMOKE), False)) for _ in range(2)]
    loss = F.make_nano_finetune_loss(model, scorers[0], F.NanoFinetuneConfig(), scorers[1])
    step, _ = FT.make_nano_finetune_fns(loss, reconstruct=False, recon_weight=0.0)
    state = T.TrainState(model, torch.optim.Adam(model.parameters(), lr=1e-4))
    batch = next(FT.synthetic_nano_batches(2, 3))
    tokens, aho = torch.as_tensor(batch['tokens']).long(), torch.as_tensor(batch['aho'])
    with _profiled():
        m = step(state, tokens, aho, 0)
    assert torch.isfinite(m['loss'])
    spans = _spans()
    assert [s['name'] for s in spans] == ['step', 'scorer', 'scorer', 'scorer',
                                          'scorer.backward']
    top = spans[0]
    assert all(s['parent'] == top['id'] and s['unit'] == top['id'] for s in spans[1:])
    assert all(s['end_ns'] is not None for s in spans)
    backward = spans[-1]
    assert backward['start_ns'] > max(s['end_ns'] for s in spans[1:4])   # after the forwards
    assert all('device_ms' not in s for s in spans)     # no events without a stream
    # an eval step under no_grad opens no backward span and hooks nothing
    tracing.reset()
    with _profiled():
        FT.make_nano_finetune_fns(loss, reconstruct=False, recon_weight=0.0)[1](
            tokens, aho, T.generator('cpu', 1, 0))
    assert _spans(names_only=True) == ['scorer', 'scorer', 'scorer']


class _FakeEvent:
    """A timing event on a stream that has always run all its work: it
    reads the host clock where it is recorded."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def query(self):
        return self.t is not None

    def synchronize(self):
        assert self.t is not None

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


class _FakeStream:
    def query(self):
        return True


def test_device_span_events_resolve_once_the_stream_passes_them(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'Event', _FakeEvent)
    monkeypatch.setattr(tracing, '_stream', lambda: _FakeStream())
    n = 3 * tracing.PENDING
    with _profiled():
        with tracing.span('outer', device=True):
            for _ in range(n):
                with tracing.span('inner', device=True):
                    pass
                assert len(tracing._events) <= tracing.PENDING + 1     # the open outer pair too
            assert [s['name'] for s in _spans()][-1] == 'inner'
    got = _spans()
    assert len(got) == n + 1 and not tracing._events
    assert all(s['device_ms'] is not None and s['device_ms'] >= 0 for s in got)
    assert got[0]['device_ms'] >= max(s['device_ms'] for s in got[1:])
    assert all(s['drained_in'] is True for s in got)


def test_a_garbage_collection_is_a_gc_span():
    with _profiled():
        with tracing.span('outer') as outer:
            gc.collect()
    got = [r for r in tracing.records() if r['name'] == 'gc']
    assert got and got[-1]['generation'] == 2 and got[-1]['end_ns'] >= got[-1]['start_ns']
    assert got[-1]['parent'] == outer['id']
    tracing.reset()
    gc.collect()
    assert tracing.records() == [] and tracing._on_gc not in gc.callbacks


def test_pretrain_profile_writes_spans_beside_the_trace(tmp_path):
    PT.main(['--config', os.path.join(REPO, 'configs', 'heavy_test.yml'), '--synthetic', '32',
             '--max-iter', '1', '--valid-step', '1', '--device', 'cpu', '--fp32', '--profile',
             '--logdir', str(tmp_path)])
    profile = tmp_path / 'profile'
    assert (profile / 'trace.json').is_file()
    spans = json.loads((profile / 'spans.json').read_text())
    steps = [s for s in spans if s['kind'] == 'span' and s['name'] == 'step']
    assert len(steps) == 2          # batch_acc 2: one iteration, two optimizer steps
    assert all(s['unit'] == s['id'] and s['end_ns'] > s['start_ns'] for s in steps)
    assert not tracing.on()
    assert np.all(np.diff([s['start_ns'] for s in steps]) > 0)
