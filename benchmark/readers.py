"""Shared arithmetic of the per-layer metric readers (``metrics/<name>.py``).

Each reader takes a ``harness.LayerContext`` and returns a number, or None
where it finds nothing to read (no device trace, no such kernel in the
window); a share of a peak or a roofline is never made up as 0.
"""
from __future__ import annotations

from typing import Optional

from . import yardstick as Y

_CALLS = {'bytenet': (('bytenet_fwd', Y.bytenet_fwd, 'K2'), ('bytenet_bwd', Y.bytenet_bwd, 'K4')),
          'attention': (('attention_fwd', Y.attention_fwd, 'K1'),
                        ('attention_bwd', Y.attention_bwd, 'K3'))}


def mfu(ctx) -> Optional[float]:
    """The traced window's model work over its length, as a share of the
    peaks: bf16 FLOPs at the bf16 peak plus float32 FLOPs at the float32
    rate (%)."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    need = ctx.work['model_flops'] / Y.BF16_FLOPS + ctx.work.get('f32_flops', 0.0) / Y.F32_FLOPS
    return 100.0 * need / ctx.trace.window_s


def roofline(ctx, family: str) -> Optional[float]:
    """The calls' bound time over their kernels' device time (%)."""
    if ctx.trace is None:
        return None
    bound = device = 0.0
    for key, count, group in _CALLS[family]:
        calls = ctx.work.get(key, [])
        if calls:
            bound += Y.bound_s(count(*c) for c in calls)
            device += ctx.trace.group_s.get(group, 0.0)
    return 100.0 * bound / device if device > 0 else None


def idle_share(ctx) -> Optional[float]:
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def span_share(ctx, name: str) -> Optional[float]:
    """The host time inside the harness span ``name`` over the traced window (%)."""
    spans = ctx.spans.get(name)
    return 100.0 * sum(spans) / ctx.host_window_s if spans and ctx.host_window_s > 0 else None


def span_ms_per_unit(ctx, *names: str) -> Optional[float]:
    """The host time inside the spans ``names`` per unit of the traced window (ms)."""
    found = [s for n in names for s in ctx.spans.get(n, [])]
    return 1e3 * sum(found) / ctx.units if found and ctx.units else None
