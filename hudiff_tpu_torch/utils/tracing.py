"""The port's tracer: spans and counters at the layer boundaries where the
host can keep the card waiting.

Tracing is on while a torch profiler session is active in the calling
thread (``torch.autograd._profiler_enabled()``; autograd's threads inherit
it), and only then: ``pretrain --profile`` and any window traced under
``torch.profiler.profile`` record spans, and ordinary runs do not. Off,
``span()`` costs that one check and hands back a shared no-op: nothing is
allocated or recorded, no CUDA event is built, and no callback stays
registered.

On, each span records its name, its start and end on the host
(``time.perf_counter_ns()``), its parent (the span open in the same
thread), and ``unit``: the id of the outermost span it runs under, shared
by every span of one request or step. Each span also records whether the
current CUDA stream had run all its queued work at the span's entry
(``drained_in``: True where CUDA is not initialized, since nothing can be
queued then; None while the stream captures a graph, which a query would
end). On one stream, a span that finds the stream drained at its entry and
does host work is time in which the card idles because of the host. A
device span (``span(name, device=True)``) also records a pair of timing
events on the stream where there is one; they resolve into ``device_ms``,
the stream's time from reaching the span's start to reaching its end, idle
stretches included: on a host-bound stretch it follows the host's pace,
not the device's work. While tracing is on, each collection of Python's
garbage collector is a ``gc`` span.

Records are dicts in a bounded buffer, in the order the spans opened:
``{'kind': 'span', 'name', 'id', 'parent', 'unit', 'start_ns', 'end_ns',
'drained_in', 'device_ms'}`` (``device_ms`` on device spans, ``generation``
on ``gc`` spans; ``end_ns`` None while open) and ``{'kind': 'count',
'name', 'n', 'unit'}`` from ``count()``. ``records()`` returns them and
``reset()`` empties the buffer.
"""
from __future__ import annotations

import collections
import functools
import gc
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

CAPACITY = 1 << 16          # records kept; the oldest go first
PENDING = 256               # device spans whose events wait to be resolved

_records: collections.deque = collections.deque(maxlen=CAPACITY)
_events: Dict[int, Tuple[dict, torch.cuda.Event, torch.cuda.Event]] = {}
_ids = itertools.count(1)
_local = threading.local()
_gc_span: Optional[dict] = None
_gc_hooked = False


def on() -> bool:
    """Whether spans and counts are recorded in this thread now."""
    return torch.autograd._profiler_enabled()


def _stack() -> List[dict]:
    stack = getattr(_local, 'stack', None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _stream():
    """The current CUDA stream; None where CUDA is not initialized or the
    stream captures a graph."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    return torch.cuda.current_stream()


def _open(name: str, device: bool, parent: Optional[dict], push: bool) -> dict:
    stream = _stream()
    sid = next(_ids)
    rec = {'kind': 'span', 'name': name, 'id': sid,
           'parent': parent['id'] if parent else None,
           'unit': parent['unit'] if parent else sid,
           'start_ns': time.perf_counter_ns(), 'end_ns': None,
           'drained_in': (stream.query() if stream is not None
                          else None if torch.cuda.is_initialized() else True)}
    if device and stream is not None:
        if len(_events) >= PENDING:
            _resolve(wait=False)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        _events[sid] = (rec, start, end)
        rec['device_ms'] = None
    _records.append(rec)
    if push:
        _stack().append(rec)
    return rec


def _close(rec: dict, pop: bool) -> None:
    if rec['id'] in _events:
        stream = _stream()
        if stream is not None:
            _events[rec['id']][2].record(stream)
        else:
            del _events[rec['id']]
    rec['end_ns'] = time.perf_counter_ns()
    if pop:
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()


def _resolve(wait: bool) -> None:
    """Turns the event pairs of closed device spans into ``device_ms``: all
    of them (``wait``: until the stream passes their ends), or those the
    stream has passed, oldest first."""
    for sid, (rec, start, end) in list(_events.items()):
        if rec['end_ns'] is None:
            continue
        if not wait and not end.query():
            break
        end.synchronize()
        rec['device_ms'] = start.elapsed_time(end)
        del _events[sid]


def _wrap(name: str, device: bool, fn):
    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with span(name, device):
            return fn(*args, **kwargs)
    return traced


class _Off:
    """The shared no-op of one span name while tracing is off."""
    __slots__ = ('name', 'device')

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _wrap(self.name, self.device, fn)


class _Span(_Off):
    """A span that records, opened by ``with``."""
    __slots__ = ('rec',)

    def __enter__(self):
        stack = _stack()
        self.rec = _open(self.name, self.device, stack[-1] if stack else None, push=True)
        return self.rec

    def __exit__(self, *exc):
        _close(self.rec, pop=True)
        return False


_OFF: Dict[Tuple[str, bool], _Off] = {}


def span(name: str, device: bool = False):
    """A span named ``name``, as a context manager or as a decorator (the
    decorated function opens one at each call). ``device``: also time the
    stream between the span's two ends."""
    if not on():
        if _gc_hooked:
            _unhook_gc()
        off = _OFF.get((name, device))
        if off is None:
            off = _OFF[(name, device)] = _Off(name, device)
        return off
    _hook_gc()
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name``, in the unit of the span open in
    this thread."""
    if not on():
        return
    stack = _stack()
    _records.append({'kind': 'count', 'name': name, 'n': n,
                     'unit': stack[-1]['unit'] if stack else None})


def backward_span(name: str, first: torch.Tensor, last: torch.Tensor) -> None:
    """A device span over a stretch of the backward pass: from the gradient
    reaching ``first`` to the gradient reaching ``last``, which lies
    upstream of ``first`` in the graph. Two gradient hooks, registered only
    while tracing is on and ``first`` takes a gradient; the span's parent
    is the span open here."""
    if not on() or not first.requires_grad:
        return
    stack = _stack()
    parent = stack[-1] if stack else None
    opened: List[dict] = []

    def begin(grad):
        if not opened:
            opened.append(_open(name, True, parent, push=False))

    def end(grad):
        if opened:
            _close(opened.pop(), pop=False)

    first.register_hook(begin)
    last.register_hook(end)


def _on_gc(phase: str, info: dict) -> None:
    global _gc_span
    if phase == 'start':
        if not on():
            _unhook_gc()
            return
        stack = _stack()
        _gc_span = _open('gc', False, stack[-1] if stack else None, push=False)
        _gc_span['generation'] = info.get('generation')
    elif _gc_span is not None:
        _close(_gc_span, pop=False)
        _gc_span = None


def _hook_gc() -> None:
    global _gc_hooked
    if not _gc_hooked:
        gc.callbacks.append(_on_gc)
        _gc_hooked = True


def _unhook_gc() -> None:
    global _gc_hooked
    if _gc_hooked:
        if _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)
        _gc_hooked = False


def records() -> List[dict]:
    """Every record kept, device spans' ``device_ms`` resolved (this waits
    for the stream to pass their ends)."""
    _resolve(wait=True)
    return list(_records)


def reset() -> None:
    """Empties the buffer (tracing stays as it is)."""
    global _gc_span
    _records.clear()
    _events.clear()
    _gc_span = None
