"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m benchmark.run`` is the same.) From the root of a checkout
that holds the program (``hudiff_tpu_torch``) and ``BENCHMARK.json``. The
cell's configuration, traffic and limits are found by its name
(``benchmark/harness.py``). The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``check``: every
number the correctness check compared, beside its limit. Progress goes to
standard error, whose last lines are the same numbers and limits.

Exits 2, printing no result, without a CUDA device or with fewer than the
cell asks for, and 3 when a module of JAX or of the JAX package
(``hudiff_tpu``) is loaded once the window has closed. Build and kernel
caches live under ``build/`` in the checkout, at fixed paths.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = ROOT / 'build' / 'bench_cache'
    for var, sub in (('TRITON_CACHE_DIR', 'triton'), ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('CUDA_CACHE_PATH', 'cuda')):
        os.environ[var] = str(base / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description='One run of one cell of the port\'s benchmark')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness as H
    import hudiff_tpu_torch  # noqa: F401  (a checkout without the program fails here)

    cell = H.Cell.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        H.log(f'{args.workload} needs {cell.chips} CUDA device(s); found {n}')
        return 2
    H.log(f'{args.workload}: seed {args.seed}, {args.seconds} s, trace {args.trace}')
    result = H.run_cell(cell, args.seed, args.seconds, bool(args.trace), 'cuda')
    H.log(f'card: {H.power_limit()}')
    found = H.banned_modules()
    if found:
        H.log(f'loaded after the window: {found}')
        return 3
    for name, c in result['check'].items():
        H.log(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})')
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
