"""Rotary position embeddings, rotate-half form.

Counterpart of hudiff_tpu/ops/rope.py. Pairs are ``(x[i], x[D/2 + i])``:
``(a', b') = (a cos - b sin, a sin + b cos)``. The released reference's
interleaved pairs map onto this layout by a fixed column permutation of the
q/k projections, applied when its checkpoints are converted.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def rope_tables(head_dim: int, length: int, theta: float = 10000.0,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [length, head_dim // 2], built in float64 with numpy
    and stored as float32."""
    if head_dim % 2:
        raise ValueError('RoPE head dim must be even')
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    angles = np.outer(np.arange(length, dtype=np.float64), freqs)
    return (torch.tensor(np.cos(angles), dtype=torch.float32, device=device),
            torch.tensor(np.sin(angles), dtype=torch.float32, device=device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., L, H, D] by position with [L, D/2] tables, in f32;
    returns x's dtype."""
    xf = x.float()
    d2 = x.shape[-1] // 2
    a, b = xf[..., :d2], xf[..., d2:]
    c = cos[:, None, :]
    s = sin[:, None, :]
    return torch.cat([a * c - b * s, a * s + b * c], dim=-1).to(x.dtype)


def apply_rope_inverse(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """The transposed rotation (hudiff_tpu/ops/pallas_attention.py:64-69,
    ``_rot_inv``), which carries a gradient back through ``apply_rope``:
    ``(a, b) -> (a cos + b sin, b cos - a sin)``, in f32; returns f32."""
    xf = x.float()
    d2 = x.shape[-1] // 2
    a, b = xf[..., :d2], xf[..., d2:]
    c = cos[:, None, :]
    s = sin[:, None, :]
    return torch.cat([a * c + b * s, b * c - a * s], dim=-1)
