"""Migrate a legacy Orbax run directory's merged qkv to the head-major layout,
into a port run directory.

Counterpart of tools/migrate_qkv_layout.py. Legacy checkpoints of the JAX
package hold each merged qkv kernel part-major (q | k | v, each
head-blocked); the layout since tensor parallelism is head-major (per head
[q_h | k_h | v_h]), and that is what the port reads. This tool reads the
directory's latest step without JAX (``training/orbax.py``), permutes every
``*/qkv/{kernel,bias}`` leaf of ``params`` and of ``opt_state`` (Adam's
moments are parameter-shaped, so a resumed run keeps its columns together),
and writes a port run directory (``checkpoints.save_training``:
``step_<n>.pt``, ``step_<n>.json``, ``LATEST``) to the second argument. It
never writes into the Orbax directory.

The ``.qkv_layout`` marker decides: ``head-major`` is refused (nothing to
migrate). JAX's ``save`` writes no marker, so a missing one is ambiguous:
the port reads it as head-major everywhere else, and this tool migrates
such a directory only with ``--legacy``, which says it predates the
head-major layout.

    python -m hudiff_tpu_torch.tools.migrate_qkv_layout <orbax_dir> <out_dir> [--legacy]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np


def headmajor_perm(heads: int, att_model: int) -> np.ndarray:
    """Column permutation: new col (h, part, i) <- old col part*A + h*hd + i."""
    hd = att_model // heads
    idx = []
    for h in range(heads):
        for part in range(3):
            idx.append(part * att_model + h * hd + np.arange(hd))
    return np.concatenate(idx)


def migrate_tree(params, heads: int, att_model: int) -> int:
    """Permute every */qkv/{kernel,bias} leaf in place; returns the count."""
    perm = headmajor_perm(heads, att_model)
    n = 0

    def walk(node):
        nonlocal n
        if isinstance(node, (list, tuple)):
            for child in node:
                walk(child)
            return
        if not isinstance(node, dict):
            return
        for key, child in node.items():
            if key == 'qkv' and isinstance(child, dict) and 'kernel' in child:
                child['kernel'] = np.asarray(child['kernel'])[..., perm]
                if 'bias' in child:
                    child['bias'] = np.asarray(child['bias'])[..., perm]
                n += 1
            else:
                walk(child)

    walk(params)
    return n


def migrate(ckpt_dir: str, out_dir: str, legacy: bool = False) -> str:
    """Write the head-major port run directory of the Orbax run directory
    ``ckpt_dir`` to ``out_dir``; returns the ``.pt`` path."""
    from ..models.denoiser import DenoiserConfig
    from ..training import checkpoints as CK
    from ..training import orbax as OB
    from ..training import schedules
    from ..utils.config import Namespace

    layout = OB.qkv_layout(ckpt_dir)
    if layout == OB.HEAD_MAJOR:
        raise ValueError(f'{ckpt_dir}: already head-major; the port reads it as it is')
    if layout is None and not legacy:
        raise ValueError(f'{ckpt_dir}: no .qkv_layout marker. JAX\'s save writes none, so '
                         'the port reads such a directory as head-major; pass --legacy '
                         'only if it predates the head-major layout')
    if os.path.abspath(out_dir) == os.path.abspath(ckpt_dir):
        raise ValueError('the output directory must not be the Orbax directory')
    restored = OB.restore_orbax(ckpt_dir, layout_check=False)
    step, meta, payload = restored['step'], restored['meta'], restored['payload']
    cfg = meta.get('config', {})
    model_cfg = cfg.get('model', cfg)
    heads = int(model_cfg.get('nhead', 8))
    att_model = int(model_cfg.get('att_model', 512))
    n = migrate_tree(payload['params'], heads, att_model)
    if payload.get('opt_state') is not None:
        n += migrate_tree(payload['opt_state'], heads, att_model)
    if n == 0:
        raise ValueError(f'{ckpt_dir}: no qkv leaves found')

    variables, dcfg, finetuned = CK.orbax_variables(restored)
    kind = CK.tree_kind(variables)
    model = CK.from_flax_params(variables, dcfg, device='cpu')
    train_cfg = cfg.get('train', cfg.get('finetune', {}))
    opt_cfg = dict((train_cfg or {}).get('optimizer') or {'type': 'Adam', 'lr': 1e-4})
    optimizer = schedules.make_optimizer(Namespace(opt_cfg), model.parameters())
    state = None
    if payload.get('opt_state') is not None:
        state = (model.state_dict(), CK.adam_state_from_optax(payload['opt_state'], model,
                                                              optimizer))
    os.makedirs(out_dir, exist_ok=True)
    config = dict(cfg, model=dataclasses.asdict(DenoiserConfig.from_dict(model_cfg)),
                  kind=kind, finetuned=finetuned)
    path = CK.save_training(out_dir, step, model, optimizer, config=config,
                            extra={k: v for k, v in meta.items() if k not in ('step', 'config')},
                            state=state)
    print(f'{ckpt_dir}: migrated {n} qkv leaves at step {step} (heads={heads}, '
          f'att_model={att_model}) into {path}', file=sys.stderr)
    return path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('ckpt_dir', help="the JAX package's Orbax run directory (read only)")
    p.add_argument('out_dir', help='the port run directory to write')
    p.add_argument('--legacy', action='store_true',
                   help='migrate a directory without a .qkv_layout marker')
    args = p.parse_args(argv)
    return migrate(args.ckpt_dir, args.out_dir, legacy=args.legacy)


if __name__ == '__main__':
    main()
