"""Readings that the correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... --units N
        [--control [fp8|bf16]] [--fault <name>]

For each seed, in one process (the kernels built once): the cell's set-up,
``N`` units of its traffic, and its check, printing one JSON line a seed
with every number compared, the program's reading beside (with
``--control``) the control's: the float32 reference put in the program's
place and computed with fp8-rounded products (``reference.denoiser.
fp8_round``), read against the float32 reference on the same inputs;
``--control bf16`` puts the reference rounded to the program's own bf16
there instead, a witness of what that precision alone reads (training
cells). The benchmark's own runs never compute the control. ``--fault`` plants one of
``faults.py``'s faults under the run. Set the limits from the
largest program reading over a dozen seeds or more and the smallest
control reading over three or more (PERF.md says how).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell_name: str, seed: int, units: int, control, device='cuda',
             fault: str = None) -> dict:
    """One seed's readings; ``control`` False, True or 'fp8' (the control),
    or 'bf16' (the witness)."""
    import contextlib
    from benchmark import faults as FL
    from benchmark import harness as H
    from benchmark.reference import denoiser as R
    cell = H.Cell.load(cell_name)
    drv_cls = H.load_module(H.BENCH_DIR / 'drivers' / f"{cell.traffic['driver']}.py",
                            'bench_driver_' + cell.traffic['driver']).Driver
    import torch
    run = H.Run(cell, seed, torch.device(device))
    driver = drv_cls(run)
    with FL.FAULTS[fault]() if fault else contextlib.nullcontext():
        driver.setup()
        for _ in range(units):
            driver.unit()
        driver.settle()
    attempted, failed = driver.attempted(), driver.failed()
    driver.release()
    got = driver.check(control=bool(control), mm=R.bf16_round if control == 'bf16' else None)
    return {'seed': seed, 'fault': fault, 'control': control, 'attempted': attempted,
            'failed': failed, 'readings': {k: v for k, (v, _) in got.items()},
            'all': getattr(driver, 'readings', None), 'worst': getattr(driver, 'worst', None)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--units', type=int, required=True)
    p.add_argument('--control', nargs='?', const='fp8', default=None, choices=('fp8', 'bf16'))
    p.add_argument('--fault', default=None, help='a fault of benchmark/faults.py to plant')
    args = p.parse_args(argv)
    os.environ.setdefault('TRITON_CACHE_DIR', str(ROOT / 'build' / 'bench_cache' / 'triton'))
    sys.path.insert(0, str(ROOT))
    from hudiff_tpu_torch.ops import _build
    _build.build_all()
    for seed in args.seeds:
        got = readings(args.workload, seed, args.units, args.control, fault=args.fault)
        print(json.dumps({'workload': args.workload, **got}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
