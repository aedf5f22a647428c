"""Shared arithmetic of the readers of the program's own spans and counters
(``hudiff_tpu_torch.utils.tracing``, on while the traced window's profiler
runs).

Each reader returns None where the program has no tracer (a checkout from
before it) or recorded nothing that it reads. Records are the tracer's
dicts: spans with ``name``, ``id``, ``parent``, ``unit`` (the outermost
span's id), ``start_ns``, ``end_ns``, ``drained_in`` (the stream had run
all its work at the span's entry) and, on device spans with a stream,
``device_ms``; counts with ``name``, ``n`` and ``unit``.
"""
from __future__ import annotations

import importlib
from typing import Dict, Iterable, List, Optional


def program_records() -> Optional[List[dict]]:
    """The tracer's records, or None without a tracer."""
    try:
        tracing = importlib.import_module('hudiff_tpu_torch.utils.tracing')
    except ImportError:
        return None
    return tracing.records()


def closed_spans(records: Iterable[dict]) -> List[dict]:
    return [r for r in records if r.get('kind') == 'span' and r.get('end_ns') is not None]


def self_ns(spans: List[dict]) -> Dict[int, int]:
    """Each span's duration less its children's (ns), by id."""
    own = {s['id']: s['end_ns'] - s['start_ns'] for s in spans}
    for s in spans:
        if s['parent'] in own:
            own[s['parent']] -= s['end_ns'] - s['start_ns']
    return own


def units_of(records, name: str) -> set:
    """The ids of the closed spans ``name``: the units they open."""
    return {s['id'] for s in closed_spans(records or []) if s['name'] == name}


def stall_s(records: Optional[List[dict]], names, units=None) -> Optional[float]:
    """The self time of the spans named ``names`` that found the stream
    drained at their entry (s): host work while the card had nothing queued.
    ``units``: only the spans of these units."""
    spans = closed_spans(records or [])
    own = self_ns(spans)
    stalled = [own[s['id']] for s in spans if s['name'] in names and s['drained_in']
               and (units is None or s['unit'] in units)]
    return sum(stalled) / 1e9 if stalled else None


def stall_share(records, names) -> Optional[float]:
    """Stall time over the program's own stretch of the window, from the
    first span's start to the last span's end (%)."""
    spans = closed_spans(records or [])
    got = stall_s(spans, names)
    if got is None:
        return None
    stretch = max(s['end_ns'] for s in spans) - min(s['start_ns'] for s in spans)
    return 100.0 * got / (stretch / 1e9) if stretch > 0 else None


def stall_ms_per_unit(records, names, unit: str) -> Optional[float]:
    """Stall time inside the spans ``unit`` (each a request), per such span (ms)."""
    units = units_of(records, unit)
    got = stall_s(records, names, units)
    return 1e3 * got / len(units) if got is not None and units else None


def count_per_unit(records, counter: str, unit: str) -> Optional[float]:
    """The counter's total inside the spans ``unit``, per such span."""
    units = units_of(records, unit)
    n = sum(r['n'] for r in records or []
            if r.get('kind') == 'count' and r['name'] == counter and r['unit'] in units)
    return n / len(units) if units and n else None


def mean_host_ms(records, name: str) -> Optional[float]:
    """The mean host duration of the spans ``name`` (ms)."""
    spans = [s for s in closed_spans(records or []) if s['name'] == name]
    return sum(s['end_ns'] - s['start_ns'] for s in spans) / len(spans) / 1e6 if spans else None


def stream_share(records, parts, whole: str) -> Optional[float]:
    """The stream time (``device_ms``: event to event, idle stretches
    included) of the spans ``parts`` over that of the spans ``whole`` (%).
    Where a span of ``whole`` has no stream time (a run without a card, whose
    work runs on the host as it is issued), host durations instead."""
    spans = [s for s in closed_spans(records or []) if s['name'] in parts or s['name'] == whole]
    if all(s.get('device_ms') is not None for s in spans if s['name'] == whole):
        took = {s['id']: s.get('device_ms') or 0.0 for s in spans}
    else:
        took = {s['id']: (s['end_ns'] - s['start_ns']) / 1e6 for s in spans}
    total = sum(took[s['id']] for s in spans if s['name'] == whole)
    part = sum(took[s['id']] for s in spans if s['name'] in parts)
    return 100.0 * part / total if total > 0 and part > 0 else None
