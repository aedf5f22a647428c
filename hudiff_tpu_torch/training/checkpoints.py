"""Weight bridge and the port's own checkpoints.

``from_flax_params`` loads the JAX package's ``AntiTFNet`` parameter tree
(as numpy arrays) into the port's ``AntiTFNet``: Flax ``Dense`` kernels are
[in, out] and become ``nn.Linear`` weights [out, in]; ``Conv`` kernels
[K, in, out] become ``DilatedConv`` weights [out, K, in]. The merged
head-major qkv projection ([q_h | k_h | v_h] per head, rotate-half RoPE
order) keeps its column order.

``save``/``load`` handle the port's checkpoint: a ``torch.save`` of
``{'config': {'model': <DenoiserConfig fields>, 'finetuned': bool},
'model': state_dict}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ..models.denoiser import AntiTFNet, DenoiserConfig

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


def flax_to_state_dict(tree: Mapping[str, Any], cfg: DenoiserConfig) -> Dict[str, torch.Tensor]:
    """The port's ``AntiTFNet`` state_dict (f32, CPU) from a Flax param tree
    (``{'params': ...}`` or the bare params)."""
    p = tree.get('params', tree)
    out: Dict[str, np.ndarray] = {}
    _leaf_params('aa_embed', p['aa_embed'], out)
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
                     dtype: torch.dtype = torch.float32,
                     device='cpu') -> AntiTFNet:
    """A loaded ``AntiTFNet`` (eval mode) computing in ``dtype`` on ``device``."""
    model = AntiTFNet(cfg, dtype=dtype, device='cpu')
    model.load_state_dict(flax_to_state_dict(tree, cfg), strict=True)
    return model.to(device).eval()


def save(path: str, model: AntiTFNet, cfg: DenoiserConfig,
         finetuned: bool = False) -> str:
    torch.save({'config': {'model': dataclasses.asdict(cfg), 'finetuned': finetuned},
                'model': {k: v.detach().cpu() for k, v in model.state_dict().items()}},
               path)
    return path


def load(path: str, dtype: torch.dtype = torch.float32,
         device='cpu') -> Tuple[AntiTFNet, dict]:
    """(model in eval mode on ``device``, the checkpoint's config dict)."""
    payload = torch.load(path, map_location='cpu', weights_only=True)
    cfg = DenoiserConfig.from_dict(payload['config']['model'])
    model = AntiTFNet(cfg, dtype=dtype, device='cpu')
    model.load_state_dict({k: v.float() for k, v in payload['model'].items()},
                          strict=True)
    return model.to(device).eval(), payload['config']
