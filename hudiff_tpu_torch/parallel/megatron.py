"""The two tensor-parallel operators of the attention stack (Megatron-LM's
f and g), as autograd Functions over a mesh's TP group.

A column-split projection (qkv, ``ff1``) reads a replicated input and gives
each rank its block of columns; a row-split one (``out``, ``ff2``) gives
each rank a partial sum of the full output. So:

- ``copy_to_tp`` goes before each column-split projection: identity
  forward, all-reduce backward. Each rank's input gradient is only its
  columns' share; without the sum, the forward still matches while every
  gradient below the attention stack is wrong;
- ``reduce_from_tp`` goes after each row-split projection: all-reduce
  forward, identity backward (every rank already holds the full output
  gradient).

Both sum in f32 and return the input's type: a bf16 partial is rounded
once, after the sum.

JAX needs neither: GSPMD derives both collectives from the parameter
shardings (hudiff_tpu/parallel/mesh.py).
"""
from __future__ import annotations

import torch

from .mesh import Mesh, all_reduce_


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce_(x.float().contiguous(), group).to(x.dtype)


class CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(dy, ctx.group), None


class ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def copy_to_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Identity forward, sum of the gradient over the TP group backward."""
    return CopyToTP.apply(x, mesh.tp_group)


def reduce_from_tp(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over the TP group forward, identity backward."""
    return ReduceFromTP.apply(x, mesh.tp_group)
