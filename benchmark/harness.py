"""One run of one cell: set-up, the measured window, the traced window, the
check, the result line.

Everything that belongs to one cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``) and
its traffic mix (``traffic/<traffic>.json``, whose ``driver`` names
``drivers/<driver>.py``); ``workloads/<cell>.json`` holds the cell's
correctness limits and traced-window length; each per-layer metric is read
by ``metrics/<metric>.py``. A driver module defines ``Driver(run)`` with:

- ``setup()``: builds the program's objects from the seed and warms every
  shape the traffic uses;
- ``unit()``: one request, round or step through the program's entry;
- ``settle()``: waits for the device (after the window's last unit);
- ``end_to_end(units, seconds)``: {metric: value} over the window;
- ``attempted()``, ``failed()``: counts over the window;
- ``work(units)``: what the traced units computed (``model_flops``,
  ``f32_flops``, and the kernel calls ``bytenet_fwd``, ``bytenet_bwd``,
  ``attention_fwd``, ``attention_bwd``);
- ``release()``: frees the program's state;
- ``check()``: {name: (value, limit)} from the reference.

A run is correct when every checked value is at most its limit.

The traced window also reads the program's launch counters: each of K1, K2,
K3 and K4 must show in the trace as many kernels as its counter moved, and
that count must be a whole, non-zero multiple of the number of calls
``work()`` lists (none where it lists none). Otherwise the run fails with no result:
a kernel the groups no longer name, or calls the counts do not describe,
would move the rooflines and ``mfu`` silently.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

from . import yardstick as Y

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BANNED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'hudiff_tpu')
# the traced window opens and closes with a kernel of its own, on an idle device
WINDOW_START, WINDOW_END = 'bessel_j0', 'bessel_j1'
# kernel group: (the program's ops module, its launch counter, the calls in work())
COUNTED = {'K1': ('fused_attention', 'launches', 'attention_fwd'),
           'K3': ('fused_attention', 'bwd_launches', 'attention_bwd'),
           'K2': ('fused_bytenet', 'launches', 'bytenet_fwd'),
           'K4': ('fused_bytenet', 'bwd_launches', 'bytenet_bwd')}


def log(msg: str) -> None:
    print(f'[bench] {msg}', file=sys.stderr, flush=True)


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(BANNED))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """A cell as the manifest and its files describe it."""
    name: str
    cfg: dict
    traffic: dict
    spec: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int

    @classmethod
    def load(cls, name: str, manifest: Optional[dict] = None) -> 'Cell':
        manifest = manifest or load_json(ROOT / 'BENCHMARK.json')
        entry = next((w for w in manifest['workloads'] if w['name'] == name), None)
        if entry is None:
            raise SystemExit(f'no workload named {name!r} in BENCHMARK.json')
        config = next(c for c in manifest['configs'] if c['name'] == entry['config'])
        e2e = [m for m in manifest['end_to_end'] if name in m.get('workloads', [name])]
        moved = {m['name'] for m in e2e}
        layer = [m for m in manifest['per_layer']
                 if (name in m['workloads'] if 'workloads' in m else m['moves'] in moved)]
        return cls(name, load_json(ROOT / config['file']),
                   load_json(BENCH_DIR / 'traffic' / f"{entry['traffic']}.json"),
                   load_json(BENCH_DIR / 'workloads' / f'{name}.json'), e2e, layer,
                   entry['chips'])


@dataclass
class Run:
    """What a driver is handed: the cell, the seed, the device, host spans."""
    cell: Cell
    seed: int
    device: object
    tracing: bool = False
    spans: Dict[str, List[float]] = field(default_factory=dict)
    span_log: list = field(default_factory=list)
    counting: bool = False
    t0: float = field(default_factory=time.perf_counter)

    def mark(self, what: str) -> None:
        """Logs how far set-up has come (seconds since the process started)."""
        log(f'{what}: {time.perf_counter() - self.t0:.3f} s')

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span around a call into the program, kept (name, start,
        end on the host clock) while the traced window runs."""
        if not self.counting:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.spans.setdefault(name, []).append(t1 - t0)
            self.span_log.append((name, t0, t1))


def process_age() -> float:
    """Seconds since this process started (its start time in /proc)."""
    try:
        with open('/proc/self/stat') as f:
            start = float(f.read().rsplit(')', 1)[1].split()[19]) / os.sysconf('SC_CLK_TCK')
        with open('/proc/uptime') as f:
            return max(0.0, float(f.read().split()[0]) - start)
    except (OSError, IndexError, ValueError):
        return 0.0


@dataclass
class Trace:
    """The traced window reduced: its length, the time the device was busy,
    each kernel group's added time and kernel count, the top device ops and
    the longest idle gaps labelled by the harness span the host was in."""
    window_s: float
    busy_s: float
    group_s: Dict[str, float]
    group_calls: Dict[str, int]
    device_ops: list
    idle_gaps: list


def reduce_trace(events, span_log, host_start: float) -> Trace:
    """The device events between the window's two marker kernels; the host
    spans (``span_log``, host clock) placed on the device's clock by the
    start marker, launched at ``host_start`` onto an idle device."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == cuda and not getattr(e, 'is_user_annotation', False)),
                    key=lambda k: k[0])
    t0 = next(s for s, _, n in device if WINDOW_START in n)
    # the profiler can drop a record at the end too: then the window closes
    # with the last kernel recorded
    t1 = next((s for s, _, n in device if WINDOW_END in n and s > t0),
              max(e for _, e, _ in device))
    kernels = [k for k in device if t0 < k[0] < t1]
    spans = [(t0 + (a - host_start) * 1e6, t0 + (b - host_start) * 1e6, n)
             for n, a, b in span_log]
    add = Y.added([(s, min(e, t1)) for s, e, _ in kernels])
    group_s, group_calls, by_name = {}, {}, {}
    for (_, _, name), a in zip(kernels, add):
        g = Y.group_of(name)
        group_s[g] = group_s.get(g, 0.0) + a / 1e6
        group_calls[g] = group_calls.get(g, 0) + 1
        by_name[name] = by_name.get(name, 0.0) + a / 1e6
    gaps, last = [], t0
    for s, e, _ in kernels:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))

    def label(a, b):
        mid = (a + b) / 2
        inside = [n for s, e, n in spans if s <= mid <= e]
        return inside[-1] if inside else 'harness'

    top_gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return Trace(window_s=(t1 - t0) / 1e6, busy_s=sum(add) / 1e6, group_s=group_s,
                 group_calls=group_calls,
                 device_ops=[[n[:160], s] for n, s in sorted(by_name.items(),
                                                             key=lambda kv: -kv[1])[:10]],
                 idle_gaps=[[label(a, b), (b - a) / 1e6] for a, b in top_gaps])


@dataclass
class LayerContext:
    """What a per-layer metric reader reads."""
    trace: Optional[Trace]
    work: dict
    spans: Dict[str, List[float]]
    host_window_s: float
    units: int


def read_layer_metrics(cell: Cell, ctx: LayerContext) -> dict:
    out = {}
    for m in cell.per_layer:
        reader = load_module(BENCH_DIR / 'metrics' / f"{m['name']}.py",
                             'bench_metric_' + m['name'].replace('.', '_'))
        value = reader.read(ctx)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def device_fields(dev, chips: int) -> dict:
    import torch
    if dev.type != 'cuda':
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 0, 'memory_peak_bytes': 0}
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(dev), 'count': chips,
            'memory_peak_bytes': int(torch.cuda.max_memory_allocated(dev))}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return 'not read'


def launch_counts() -> Dict[str, int]:
    """The program's launch counters of K1-K4, by kernel group."""
    import importlib
    return {g: getattr(importlib.import_module(f'hudiff_tpu_torch.ops.{mod}'), counter)
            for g, (mod, counter, _) in COUNTED.items()}


def launch_faults(trace: Trace, launched: Dict[str, int], work: dict) -> List[str]:
    """Where the traced kernels, the launch counters' deltas and the calls
    that ``work()`` lists disagree (the module's docstring)."""
    out = []
    for g, (_, counter, key) in COUNTED.items():
        seen, n, calls = trace.group_calls.get(g, 0), launched[g], len(work.get(key, []))
        if seen != n:
            out.append(f'{g}: {seen} kernels in the trace, {n} by the counter {counter}')
        if (n % calls or n == 0) if calls else n:
            out.append(f'{g}: {n} kernels launched for {calls} calls ({key})')
    return out


def _traced(run: Run, driver, n_units: int):
    """``n_units`` units under the profiler (device activity alone: recording
    the host's operations would slow a host-bound step several times), after
    a warm-up of its own: (units, host seconds, the trace, the launch
    counters' deltas)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    on_card = run.device.type == 'cuda'
    x = torch.full((64,), 0.5, device=run.device)
    with profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]) as prof:
        # the profiler can drop the first records it sees: warm it on a few
        # small launches of its own, outside the window
        for _ in range(64):
            x.mul_(1.0)
        driver.settle()
        time.sleep(0.05)
        run.counting = True
        before = launch_counts()
        host_start = time.perf_counter()
        torch.special.bessel_j0(x)
        for _ in range(n_units):
            driver.unit()
        driver.settle()
        host_s = time.perf_counter() - host_start
        after = launch_counts()
        run.counting = False
        torch.special.bessel_j1(x)
        for _ in range(64):
            x.mul_(1.0)
        driver.settle()
    trace = reduce_trace(prof.events(), run.span_log, host_start) if on_card else None
    return n_units, host_s, trace, {g: after[g] - before[g] for g in after}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             driver_cls=None) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's object
    (the check's numbers under ``check``, last)."""
    import torch
    setup_t0 = time.perf_counter() - process_age()
    dev = torch.device(device)
    if dev.type == 'cuda':
        from hudiff_tpu_torch.ops import _build
        took = _build.build_all()
        log(f'kernels built: {took}')
    if driver_cls is None:
        driver_cls = load_module(BENCH_DIR / 'drivers' / f"{cell.traffic['driver']}.py",
                                 'bench_driver_' + cell.traffic['driver']).Driver
    run = Run(cell, seed, dev, tracing=trace, t0=setup_t0)
    run.mark('torch and the program imported, kernels loaded')
    driver = driver_cls(run)
    driver.setup()
    driver.settle()
    t_start = time.perf_counter()
    setup_s = t_start - setup_t0
    log(f'set-up {setup_s:.3f} s')
    metrics, extra = {}, {}
    if trace:
        units, host_s, tr, launched = _traced(run, driver, int(cell.spec['trace_units']))
        ctx = LayerContext(tr, driver.work(units), run.spans, host_s, units)
        if tr is not None:
            faults = launch_faults(tr, launched, ctx.work)
            if faults:
                raise RuntimeError('the traced window does not match the launch counters: '
                                   + '; '.join(faults))
        metrics = read_layer_metrics(cell, ctx)
        if tr is not None:
            extra['busy_s'], extra['window_s'] = tr.busy_s, tr.window_s
            extra['breakdown'] = {'device_ops': tr.device_ops, 'idle_gaps': tr.idle_gaps}
            log(f'groups (s): {tr.group_s}; kernels: {tr.group_calls}; launched: {launched}')
    else:
        units = 0
        while True:
            driver.unit()
            units += 1
            if time.perf_counter() - t_start >= seconds:
                break
        driver.settle()
        window_s = time.perf_counter() - t_start
        log(f'window: {units} units in {window_s:.3f} s')
        e2e = driver.end_to_end(units, window_s)
        e2e['setup_s'] = setup_s
        metrics = {m['name']: {'value': e2e[m['name']], 'unit': m['unit']}
                   for m in cell.end_to_end}
    dev_fields = device_fields(dev, cell.chips)
    dev_fields.update({k: extra[k] for k in ('busy_s', 'window_s') if k in extra})
    attempted, failed = driver.attempted(), driver.failed()
    driver.release()
    checked = driver.check()
    correct = all(math.isfinite(v) and v <= lim for v, lim in checked.values())
    result = {'correct': correct, 'attempted': attempted, 'failed': failed,
              'metrics': metrics, 'device': dev_fields}
    if 'breakdown' in extra:
        result['breakdown'] = extra['breakdown']
    result['check'] = {k: {'value': v, 'limit': lim} for k, (v, lim) in checked.items()}
    return result
