"""Random weights from the seed, made on the device in one draw.

The benchmark makes one set of float32 parameters and hands the same dict
to the program (``load_state_dict``) and to the reference. The values come
from a single ``torch.rand`` over all of them on the run's device, cut into
leaves and scaled by kind:

- LayerNorm gains 1 + U(-0.1, 0.1), LayerNorm shifts U(-0.05, 0.05);
- embedding tables U(-sqrt 3, sqrt 3) (unit variance);
- matrices and conv weights U(-1, 1) / sqrt(fan_in), as torch's default
  initialisers bound them; their biases the same bound.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch


def _is_norm(name: str) -> bool:
    module = name.split('.')[-2] if '.' in name else ''
    return module.startswith('ln') or 'norm' in module


def make(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for ``shapes`` (name, shape) from ``seed``."""
    shapes = list(shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    total = sum(math.prod(s) for _, s in shapes)
    flat = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    fan_in = {}
    for name, shape in shapes:
        if name.endswith('.weight') and len(shape) >= 2:
            fan_in[name[:-len('.weight')]] = math.prod(shape[1:])
    out, at = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        u = flat[at:at + n].view(shape)
        at += n
        module = name.rsplit('.', 1)[0]
        if _is_norm(name):
            out[name] = 1.0 + 0.1 * u if name.endswith('weight') else 0.05 * u
        elif 'embed' in module and len(shape) == 2:
            out[name] = math.sqrt(3.0) * u
        else:
            out[name] = u / math.sqrt(fan_in.get(module, shape[-1]))
    return out
