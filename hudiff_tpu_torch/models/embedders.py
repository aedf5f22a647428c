"""Conditioning embedders: sinusoidal positions, chain side, region type.

Counterpart of hudiff_tpu/models/embedders.py:14-121 (``NanoSideEmbedder``
included). Each module computes
in ``dtype`` (its parameters may be f32 or, after the sampler's cast-once,
bf16); LayerNorms run in f32 with the JAX package's numerics (ops/norm.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import LN_EPS, layer_norm


def sinusoidal_table(d_model: int, max_len: int) -> np.ndarray:
    """Standard transformer sinusoidal PE table [max_len, d_model] (f32)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` applied in ``dtype`` (inputs, weight and bias cast)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def norm(x: torch.Tensor, layer: nn.LayerNorm) -> torch.Tensor:
    return layer_norm(x, layer.weight, layer.bias, layer.eps)


class GatedMLP(nn.Module):
    """Linear(d -> 2d) -> exact GELU -> Linear(2d -> d) -> dropout (training only)."""

    def __init__(self, d: int, dropout: float = 0.5, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.dropout = dtype, dropout
        self.fc1 = nn.Linear(d, 2 * d, device=device)
        self.fc2 = nn.Linear(2 * d, d, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = dense(F.gelu(dense(x, self.fc1, self.dtype)), self.fc2, self.dtype)
        return F.dropout(x, self.dropout, training=self.training)


class PosEmbedder(nn.Module):
    """(x + PE) + GatedMLP(x + PE)."""

    def __init__(self, d: int, max_len: int, dtype=torch.float32, device=None):
        super().__init__()
        self.register_buffer('pe', torch.tensor(sinusoidal_table(d, max_len),
                                                device=device), persistent=False)
        self.mlp = GatedMLP(d, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.pe[: x.shape[1]].to(x.dtype)
        return x + self.mlp(x)


class SideEmbedder(nn.Module):
    """Chain types [B, 2] = (heavy, light) -> [B, h_len + l_len, d]: each
    chain's embedding repeated over its rows."""

    def __init__(self, n_side: int, s_embedding: int, d: int, h_len: int,
                 l_len: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.h_len, self.l_len = dtype, h_len, l_len
        self.embed = nn.Embedding(n_side, s_embedding, device=device)
        self.fc1 = nn.Linear(s_embedding, d, device=device)
        self.ln = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.fc2 = nn.Linear(d, d, device=device)

    def forward(self, chain_type: torch.Tensor) -> torch.Tensor:
        h = self.embed(chain_type).to(self.dtype)                  # [B, 2, s]
        h = F.relu(norm(dense(h, self.fc1, self.dtype), self.ln))
        h = dense(h, self.fc2, self.dtype)                          # [B, 2, d]
        return torch.cat([h[:, 0:1].expand(-1, self.h_len, -1),
                          h[:, 1:2].expand(-1, self.l_len, -1)], dim=1)


class NanoSideEmbedder(nn.Module):
    """Single-chain variant: chain types [B] -> [B, h_len, d]. The JAX
    package defines it and no model calls it; nor does the port's."""

    def __init__(self, n_side: int, s_embedding: int, d: int, h_len: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.h_len = dtype, h_len
        self.embed = nn.Embedding(n_side, s_embedding, device=device)
        self.fc1 = nn.Linear(s_embedding, d, device=device)
        self.ln = nn.LayerNorm(d, eps=LN_EPS, device=device)
        self.fc2 = nn.Linear(d, d, device=device)

    def forward(self, chain_type: torch.Tensor) -> torch.Tensor:
        h = self.embed(chain_type).to(self.dtype)                  # [B, s]
        h = F.relu(norm(dense(h, self.fc1, self.dtype), self.ln))
        h = dense(h, self.fc2, self.dtype)                          # [B, d]
        return h[:, None].expand(-1, self.h_len, -1)


class RegionEmbedder(nn.Module):
    """FR/CDR region ids [B, L] -> [B, L, d]."""

    def __init__(self, n_region: int, r_embedding: int, d: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.Embedding(n_region, r_embedding, device=device)
        self.ln1 = nn.LayerNorm(r_embedding, eps=LN_EPS, device=device)
        self.fc = nn.Linear(r_embedding, d, device=device)
        self.ln2 = nn.LayerNorm(d, eps=LN_EPS, device=device)

    def forward(self, region: torch.Tensor) -> torch.Tensor:
        x = F.relu(norm(self.embed(region).to(self.dtype), self.ln1))
        return F.relu(norm(dense(x, self.fc, self.dtype), self.ln2))
