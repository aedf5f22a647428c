"""ByteNet-style dilated-convolution residual blocks.

Counterpart of hudiff_tpu/ops/bytenet.py. A block is

    y = x + W2 act(LN3 conv(act(LN2 (W1 act(LN1 x)))))

with the parameters held as torch modules (``nn.LayerNorm``, ``nn.Linear``
and ``DilatedConv``, whose weight is laid out [out, K, in]) and the
computation done by
``ops/fused_bytenet.py::bytenet_block``, which routes by device: the plain
version on the CPU, the K2 kernels on CUDA. Dropout after each block of a
stack is active only in training mode.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .fused_bytenet import bytenet_block
from .norm import LN_EPS


def dilation_schedule(n_layers: int, r: int) -> List[int]:
    """Dilations cycle through powers of two up to r."""
    log2 = int(np.log2(r)) + 1
    return [2 ** (n % log2) for n in range(n_layers)]


class DilatedConv(nn.Module):
    """Parameters of a same-padded dilated conv (channels -> channels).

    ``weight`` is [out, K, in]: ``nn.Conv1d``'s [out, in, K] with the tap axis
    moved next to the output axis, so that the conv is one GEMM over a
    row-major [out, K * in] matrix in the K2 kernel. Initialised as
    ``nn.Conv1d`` is. The block's kernel (or its plain version) applies it."""

    def __init__(self, channels: int, kernel_size: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, kernel_size, channels,
                                               device=device))
        self.bias = nn.Parameter(torch.empty(channels, device=device))
        bound = 1.0 / math.sqrt(channels * kernel_size)
        nn.init.uniform_(self.weight, -bound, bound)
        nn.init.uniform_(self.bias, -bound, bound)


class ByteNetBlock(nn.Module):
    """Residual block x + FF2(Conv(FF1(x))) over one chain [B, L, d_model]."""

    def __init__(self, d_model: int, d_h: int, kernel_size: int,
                 dilation: int = 1, activation: str = 'relu', device=None):
        super().__init__()
        kw = dict(device=device)
        self.dilation = dilation
        self.activation = activation
        self.ln1 = nn.LayerNorm(d_model, eps=LN_EPS, **kw)
        self.fc1 = nn.Linear(d_model, d_h, **kw)
        self.ln2 = nn.LayerNorm(d_h, eps=LN_EPS, **kw)
        self.conv = DilatedConv(d_h, kernel_size, **kw)
        self.ln3 = nn.LayerNorm(d_h, eps=LN_EPS, **kw)
        self.fc2 = nn.Linear(d_h, d_model, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bytenet_block(
            x, self.ln1.weight, self.ln1.bias, self.fc1.weight, self.fc1.bias,
            self.ln2.weight, self.ln2.bias, self.conv.weight, self.conv.bias,
            self.ln3.weight, self.ln3.bias, self.fc2.weight, self.fc2.bias,
            dilation=self.dilation, activation_name=self.activation)


class ByteNetStack(nn.Module):
    """N blocks over the power-of-two dilation cycle; slim: d_h = d_model // 2."""

    def __init__(self, n_layers: int, d_model: int, kernel_size: int, r: int,
                 activation: str = 'relu', dropout: float = 0.0, device=None):
        super().__init__()
        self.dropout = dropout
        self.blocks = nn.ModuleList(
            ByteNetBlock(d_model, d_model // 2, kernel_size, dilation=d,
                         activation=activation, device=device)
            for d in dilation_schedule(n_layers, r))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
            if self.dropout > 0.0:
                x = F.dropout(x, self.dropout, training=self.training)
        return x
