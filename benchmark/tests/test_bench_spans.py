"""The readers of the program's spans and counters (``benchmark/spans.py``
and the five ``metrics/*.py`` that use it) on a synthetic record list, and
each reader's None without a tracer or without records."""
import sys
from pathlib import Path

import pytest

from benchmark import harness as H
from benchmark import spans as S

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000
READERS = ('host_stall_share.humanize', 'host_stall_ms.request', 'rounds_per_request.request',
           'host_issue_ms.train', 'abnativ_stream_share.train')


def _span(sid, name, start_ms, end_ms, parent=None, drained=True, device_ms=None, unit=None):
    rec = {'kind': 'span', 'name': name, 'id': sid, 'parent': parent,
           'unit': unit or parent or sid, 'start_ns': start_ms * MS, 'end_ns': end_ms * MS,
           'drained_in': drained}
    if device_ms is not None:
        rec['device_ms'] = device_ms
    return rec


def _count(name, n, unit):
    return {'kind': 'count', 'name': name, 'n': n, 'unit': unit}


# two Nb requests: the first with a rejected round, the second with a gc
# inside its nano_input; a span left open, a span that found the stream
# busy, and a gc and a round outside any request count for nothing per
# request
RECORDS = [
    _span(1, 'humanize', 0, 120),
    _span(2, 'nano_input', 0, 10, parent=1),
    _count('rounds', 1, 1), _span(3, 'round.prep', 10, 12, parent=1),
    _span(4, 'filter', 60, 70, parent=1),
    _count('rounds', 1, 1), _span(5, 'round.prep', 70, 73, parent=1),
    _span(6, 'filter', 110, 120, parent=1),
    _span(7, 'humanize', 200, 300),
    _span(8, 'nano_input', 200, 215, parent=7),
    _span(9, 'gc', 205, 209, parent=8, unit=7),
    _count('rounds', 1, 7), _span(10, 'round.prep', 215, 217, parent=7, drained=False),
    _span(11, 'filter', 290, 300, parent=7),
    {**_span(12, 'filter', 300, 301, parent=7), 'end_ns': None},
    _span(13, 'gc', 350, 355), _count('rounds', 1, None),
    # two fine-tune steps: 3 scorers and a backward each
    _span(20, 'step', 400, 480, device_ms=100.0),
    _span(21, 'scorer', 410, 411, parent=20, device_ms=5.0),
    _span(22, 'scorer', 412, 413, parent=20, device_ms=5.0),
    _span(23, 'scorer', 414, 415, parent=20, device_ms=5.0),
    _span(24, 'scorer.backward', 420, 421, parent=20, device_ms=15.0),
    _span(25, 'step', 500, 560, device_ms=100.0),
    _span(26, 'scorer', 510, 511, parent=25, device_ms=6.0),
]
NB = ('nano_input', 'round.prep', 'filter', 'gc')


def test_self_time_is_duration_less_children():
    own = S.self_ns(S.closed_spans(RECORDS))
    assert own[1] == (120 - 10 - 2 - 10 - 3 - 10) * MS
    assert own[8] == 11 * MS and own[9] == 4 * MS
    assert 12 not in own


def test_stall_time_reads_drained_spans_alone():
    # 10 + 2 + 10 + 3 + 10 (first request), 11 + 4 + 10 (second; the busy
    # round.prep left out), 5 (the gc outside the requests)
    assert S.stall_s(RECORDS, NB) == pytest.approx(0.065)
    assert S.stall_s(RECORDS, NB, units={1, 7}) == pytest.approx(0.060)
    assert S.stall_ms_per_unit(RECORDS, NB, 'humanize') == pytest.approx(30.0)
    # over the program's stretch, 0-560 ms
    assert S.stall_share(RECORDS, NB) == pytest.approx(100 * 65 / 560)
    assert S.stall_s(RECORDS, ('result',)) is None
    assert S.stall_ms_per_unit(RECORDS, NB, 'request') is None


def test_counts_steps_and_device_shares():
    assert S.count_per_unit(RECORDS, 'rounds', 'humanize') == 1.5
    assert S.mean_host_ms(RECORDS, 'step') == pytest.approx(70.0)
    assert S.stream_share(RECORDS, ('scorer', 'scorer.backward'), 'step') == pytest.approx(18.0)
    assert S.stream_share(RECORDS, ('round.prep',), 'step') is None     # no stream time
    # spans without stream time (a run without a card): host durations, 4 ms of 220
    assert S.stream_share(RECORDS, ('scorer',), 'humanize') == pytest.approx(100 * 4 / 220)


def _reader(name):
    return H.load_module(ROOT / 'benchmark' / 'metrics' / f'{name}.py',
                         'test_metric_' + name.replace('.', '_'))


@pytest.mark.parametrize('name, want', [
    ('host_stall_share.humanize', 100 * 14 / 560), ('host_stall_ms.request', 30.0),
    ('rounds_per_request.request', 1.5), ('host_issue_ms.train', 70.0),
    ('abnativ_stream_share.train', 18.0)])
def test_readers_on_records(monkeypatch, name, want):
    monkeypatch.setattr(S, 'program_records', lambda: RECORDS)
    ctx = H.LayerContext(None, {}, {}, host_window_s=0.5, units=2)
    got = _reader(name).read(ctx)
    assert got == (None if want is None else pytest.approx(want))


def test_humanize_stall_share_reads_its_own_spans(monkeypatch):
    records = [_span(1, 'pair_input', 0, 30), _span(2, 'humanize', 30, 400),
               _span(3, 'round.prep', 30, 40, parent=2),
               _span(4, 'result', 390, 400, parent=2), _span(5, 'gc', 400, 410)]
    monkeypatch.setattr(S, 'program_records', lambda: records)
    # the harness's window (here 2 s, as with a cold marker kernel) is not read
    ctx = H.LayerContext(None, {}, {}, host_window_s=2.0, units=1)
    assert _reader('host_stall_share.humanize').read(ctx) == pytest.approx(100 * 60 / 410)


@pytest.mark.parametrize('name', READERS)
@pytest.mark.parametrize('found', ['no_tracer', 'no_records'])
def test_readers_return_none_without_a_tracer_or_records(monkeypatch, name, found):
    if found == 'no_tracer':
        # a checkout from before the tracer: the import fails
        monkeypatch.setitem(sys.modules, 'hudiff_tpu_torch.utils.tracing', None)
        assert S.program_records() is None
    else:
        monkeypatch.setattr(S, 'program_records', lambda: [])
    ctx = H.LayerContext(None, {}, {}, host_window_s=0.5, units=2)
    assert _reader(name).read(ctx) is None


def test_program_records_reads_the_tracer():
    from hudiff_tpu_torch.utils import tracing
    import torch
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span('step'):
            pass
    got = S.program_records()
    tracing.reset()
    assert [r['name'] for r in got] == ['step'] and S.mean_host_ms(got, 'step') >= 0
