"""LayerNorm and activations with the JAX package's numerics.

flax.linen.LayerNorm uses eps 1e-6 and the fast variance E[x^2] - E[x]^2
(clipped at 0), computed in f32; torch's default eps is 1e-5. Here every
plain LayerNorm is torch's fused one with eps 1e-6, in f32: its two-pass
variance agrees with the fast one to f32 rounding. GELU is the exact (erf)
form everywhere.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LN_EPS = 1e-6


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (one fused torch call); returns
    x's dtype. Its two-pass variance differs from Flax's fast variance only
    by f32 rounding."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)


def activation(x: torch.Tensor, name: str) -> torch.Tensor:
    """'relu' or exact-erf 'gelu'."""
    if name == 'relu':
        return F.relu(x)
    if name == 'gelu':
        return F.gelu(x)
    raise ValueError(f'unknown activation {name!r}')
