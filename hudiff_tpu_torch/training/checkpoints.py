"""Weight bridge and the port's own checkpoints.

``from_flax_params`` loads the JAX package's ``AntiTFNet`` or
``NanoAntiTFNet`` parameter tree (as numpy arrays; the tree's
``nano_conv`` says which) into the port's model of the same name: Flax
``Dense`` kernels are [in, out] and become ``nn.Linear`` weights [out, in];
``Conv`` kernels [K, in, out] become ``DilatedConv`` weights [out, K, in].
The merged head-major qkv projection ([q_h | k_h | v_h] per head,
rotate-half RoPE order) keeps its column order.

``save``/``load`` handle the port's checkpoint: a ``torch.save`` of
``{'config': {'model': <DenoiserConfig fields>, 'finetuned': bool, 'kind':
'pair' | 'heavy'}, 'model': state_dict}``. ``kind`` names the model, as the
JAX pretrain's metadata does: ``'heavy'`` is ``NanoAntiTFNet``; a file
without it is ``'pair'`` (``AntiTFNet``).

``save_training``/``restore``/``latest_step`` handle pretraining's
best-val checkpoints, with the JAX package's layout
(hudiff_tpu/training/checkpoints.py:18-85) in ``torch.save`` form instead
of Orbax: ``<dir>/step_<it>.pt`` holds the same ``config`` and ``model``
entries plus ``'optimizer'`` (the optimizer's ``state_dict``), so ``load``
reads its model part too; beside it ``step_<it>.json`` holds ``step``,
``config``, ``val_loss``, ``opt_steps`` and ``scheduler``, and ``LATEST``
names the newest step. ``restore`` returns the kind beside the payload;
``model_class(kind)`` is the class to load it into.

``from_flax_params`` and ``load`` run on ``cuda`` unless the caller passes
``device='cpu'``; without a card they raise.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.denoiser import AntiTFNet, DenoiserConfig, NanoAntiTFNet
from ..utils.device import resolve_device

_BLOCK = (('LayerNorm_0', 'ln1'), ('Dense_0', 'fc1'), ('LayerNorm_1', 'ln2'),
          ('LayerNorm_2', 'ln3'), ('Dense_1', 'fc2'))
_SIDE = (('Embed_0', 'embed'), ('Dense_0', 'fc1'), ('LayerNorm_0', 'ln'),
         ('Dense_1', 'fc2'))
_REGION = (('Embed_0', 'embed'), ('LayerNorm_0', 'ln1'), ('Dense_0', 'fc'),
           ('LayerNorm_1', 'ln2'))
_ATT_BLOCK = (('norm1', 'norm1'), ('norm2', 'norm2'), ('Dense_0', 'ff1'),
              ('Dense_1', 'ff2'))


def _leaf_params(dst: str, node: Mapping[str, Any], out: Dict[str, np.ndarray]) -> None:
    """One Flax Dense / Conv / LayerNorm / Embed node -> torch entries."""
    if 'embedding' in node:
        out[f'{dst}.weight'] = np.asarray(node['embedding'])
        return
    if 'scale' in node:
        out[f'{dst}.weight'] = np.asarray(node['scale'])
    else:
        k = np.asarray(node['kernel'])
        out[f'{dst}.weight'] = k.T if k.ndim == 2 else k.transpose(2, 0, 1)
    out[f'{dst}.bias'] = np.asarray(node['bias'])


def _named(dst: str, node: Mapping[str, Any], names, out) -> None:
    for src, name in names:
        _leaf_params(f'{dst}.{name}', node[src], out)


def _tower(dst: str, node: Mapping[str, Any], out) -> None:
    for i in range(len(node)):
        blk = node[f'ByteNetBlock_{i}']
        _named(f'{dst}.blocks.{i}', blk, _BLOCK, out)
        _leaf_params(f'{dst}.blocks.{i}.conv', blk['DilatedConv1d_0']['Conv_0'], out)


def model_class(kind: str):
    """The model a checkpoint of ``kind`` holds: ``'pair'`` -> ``AntiTFNet``,
    ``'heavy'`` -> ``NanoAntiTFNet``."""
    if kind not in ('pair', 'heavy'):
        raise ValueError(f"unknown model kind {kind!r}: expected 'pair' or 'heavy'")
    return AntiTFNet if kind == 'pair' else NanoAntiTFNet


def model_kind(model: torch.nn.Module) -> str:
    return 'heavy' if isinstance(model, NanoAntiTFNet) else 'pair'


def tree_kind(tree: Mapping[str, Any]) -> str:
    """``'heavy'`` for a Flax ``NanoAntiTFNet`` tree, else ``'pair'``."""
    return 'heavy' if 'nano_conv' in tree.get('params', tree) else 'pair'


def flax_to_state_dict(tree: Mapping[str, Any], cfg: DenoiserConfig) -> Dict[str, torch.Tensor]:
    """The state_dict (f32, CPU) of the port's ``AntiTFNet`` or
    ``NanoAntiTFNet`` (``tree_kind``) from a Flax param tree
    (``{'params': ...}`` or the bare params)."""
    p = tree.get('params', tree)
    out: Dict[str, np.ndarray] = {}
    _leaf_params('aa_embed', p['aa_embed'], out)
    if tree_kind(p) == 'heavy':
        _tower('aa_encoder', p['aa_encoder'], out)
        _tower('nano_conv', p['nano_conv'], out)
    else:
        for name in ('aa_encoder', 'dual_conv'):
            _tower(f'{name}.h_tower', p[name]['h_tower'], out)
            _tower(f'{name}.l_tower', p[name]['l_tower'], out)
        _named('side_encoder', p['side_encoder'], _SIDE, out)
    _named('region_encoder', p['region_encoder'], _REGION, out)
    _named('pos_encoder.mlp', p['pos_encoder']['GatedMLP_0'],
           (('Dense_0', 'fc1'), ('Dense_1', 'fc2')), out)
    for i in range(cfg.cs_layers):
        blk = p['self_att'][f'block_{i}']
        dst = f'self_att.blocks.{i}'
        for att in ('attn', 'attn_c'):
            _named(f'{dst}.{att}', blk[att], (('qkv', 'qkv'), ('out', 'out')), out)
        _named(dst, blk, _ATT_BLOCK, out)
    _leaf_params('last_norm', p['last_norm'], out)
    _leaf_params('decoder', p['decoder'], out)
    return {k: torch.tensor(np.asarray(v, dtype=np.float32))
            for k, v in out.items()}


def from_flax_params(tree: Mapping[str, Any], cfg: DenoiserConfig,
                     dtype: torch.dtype = torch.float32, device='cuda'):
    """A loaded ``AntiTFNet`` or ``NanoAntiTFNet`` (eval mode) computing in
    ``dtype`` on ``device``."""
    device = resolve_device(device)
    model = model_class(tree_kind(tree))(cfg, dtype=dtype, device='cpu')
    model.load_state_dict(flax_to_state_dict(tree, cfg), strict=True)
    return model.to(device).eval()


def _host_state(module) -> Dict[str, Any]:
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save(path: str, model: torch.nn.Module, cfg: DenoiserConfig,
         finetuned: bool = False) -> str:
    torch.save({'config': {'model': dataclasses.asdict(cfg), 'finetuned': finetuned,
                           'kind': model_kind(model)},
                'model': _host_state(model)}, path)
    return path


def load(path: str, dtype: torch.dtype = torch.float32,
         device='cuda') -> Tuple[torch.nn.Module, dict]:
    """(model in eval mode on ``device``, the checkpoint's config dict), from
    a ``save`` or a ``save_training`` file; the config's ``kind`` (default
    ``'pair'``) names the model."""
    device = resolve_device(device)
    payload = torch.load(path, map_location='cpu', weights_only=True)
    cfg = DenoiserConfig.from_dict(payload['config']['model'])
    model = model_class(payload['config'].get('kind', 'pair'))(cfg, dtype=dtype,
                                                                device='cpu')
    model.load_state_dict({k: v.float() for k, v in payload['model'].items()},
                          strict=True)
    return model.to(device).eval(), payload['config']


def save_training(ckpt_dir: str, step: int, model: torch.nn.Module,
                  optimizer: torch.optim.Optimizer, config: Optional[dict] = None,
                  extra: Optional[dict] = None) -> str:
    """Write ``step_<step>.pt`` (model and optimizer state), its
    ``step_<step>.json`` metadata and the ``LATEST`` marker; returns the
    ``.pt`` path. ``config`` is plain data: ``{'model': ..., 'train': ...,
    'kind': ...}`` (a fine-tune's also ``'finetuned': True``, which the
    ``.pt`` file's config keeps for ``load``); the kind saved is the
    model's."""
    config = dict(config or {}, kind=model_kind(model))
    path = os.path.abspath(os.path.join(ckpt_dir, f'step_{step}.pt'))
    torch.save({'config': {'model': dict(config.get('model', {})),
                           'finetuned': bool(config.get('finetuned', False)),
                           'kind': config['kind']},
                'model': _host_state(model),
                'optimizer': optimizer.state_dict()}, path)
    meta = {'step': step, 'config': config, **(extra or {})}
    with open(os.path.join(ckpt_dir, f'step_{step}.json'), 'w') as f:
        json.dump(meta, f, indent=2, default=float)
    with open(os.path.join(ckpt_dir, 'LATEST'), 'w') as f:
        f.write(str(step))
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step named by ``LATEST``, else the largest ``step_<n>.pt``."""
    marker = os.path.join(ckpt_dir, 'LATEST')
    if os.path.exists(marker):
        with open(marker) as f:
            return int(f.read().strip())
    steps = []
    if os.path.isdir(ckpt_dir):
        for name in os.listdir(ckpt_dir):
            stem, ext = os.path.splitext(name)
            if stem.startswith('step_') and ext == '.pt' and stem[5:].isdigit():
                steps.append(int(stem[5:]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """``{'payload': {'config', 'model', 'optimizer'}, 'meta': ..., 'step':
    ..., 'kind': ...}`` of ``step`` (default: the latest), tensors on the
    CPU; ``model_class(kind)`` takes ``payload['model']``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f'no checkpoints under {ckpt_dir}')
    payload = torch.load(os.path.join(ckpt_dir, f'step_{step}.pt'), map_location='cpu',
                         weights_only=True)
    meta_path = os.path.join(ckpt_dir, f'step_{step}.json')
    meta = {'step': step}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return {'payload': payload, 'meta': meta, 'step': step,
            'kind': payload['config'].get('kind', 'pair')}
