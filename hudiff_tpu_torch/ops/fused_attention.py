"""K1: fused RoPE attention over a head-major merged qkv projection.

Counterpart of hudiff_tpu/ops/pallas_attention.py (``rope_attention_qkv``
and its TPU kernel ``_rope_fwd_kernel_qkv``). The CUDA kernel is
``csrc/rope_attention.cu``; its header says what bounds it on an H100 and
how its design answers that.

``rope_attention_qkv`` routes by the tensor's device alone: a CPU tensor
takes the plain version below, a CUDA tensor launches the kernel (or
raises). ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .rope import apply_rope

HEAD_DIM = 64
launches = 0

_SIGNATURES = {
    'hd_rope_attention_qkv': [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_int, ctypes.c_void_p],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_qkv_heads(qkv: torch.Tensor, heads: int):
    """Head-major merged qkv [B, L, H*3*D] -> (q, k, v) each [B, L, H*D]."""
    B, L, A3 = qkv.shape
    hd = A3 // 3 // heads
    g = qkv.reshape(B, L, heads, 3, hd)
    return tuple(g[:, :, :, i].reshape(B, L, heads * hd) for i in range(3))


def rope_attention_qkv_reference(qkv: torch.Tensor, cos: torch.Tensor,
                                 sin: torch.Tensor, scale: float,
                                 heads: int) -> torch.Tensor:
    """Plain version: split, rotate q/k in f32, scores of input-type values
    accumulated in f32 and scaled after the product, softmax over all L,
    P cast to v's type, P v accumulated in f32. Returns [B, L, H*D] in v's
    type (pallas_attention.py:425-432)."""
    q, k, v = split_qkv_heads(qkv, heads)
    B, L, A = q.shape
    D = A // heads
    qh = apply_rope(q.reshape(B, L, heads, D), cos, sin)
    kh = apply_rope(k.reshape(B, L, heads, D), cos, sin)
    vh = v.reshape(B, L, heads, D)
    logits = torch.einsum('blhd,bmhd->bhlm', qh.float(), kh.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum('bhlm,bmhd->blhd', probs.float(), vh.float())
    return out.reshape(B, L, A).to(v.dtype)


def rope_attention_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                       scale: float, heads: int) -> torch.Tensor:
    """RoPE attention on head-major merged qkv [B, L, heads*3*64] with
    [L, 32] f32 rotate-half tables; returns [B, L, heads*64]."""
    global launches
    if qkv.device.type == 'cpu':
        return rope_attention_qkv_reference(qkv, cos, sin, scale, heads)
    B, L, A3 = qkv.shape
    if qkv.device.type != 'cuda':
        raise ValueError(f'rope_attention_qkv: unsupported device {qkv.device}')
    if qkv.dtype not in _DTYPES:
        raise TypeError(f'rope_attention_qkv: dtype {qkv.dtype} not supported')
    if A3 != heads * 3 * HEAD_DIM:
        raise ValueError(f'rope_attention_qkv: head dim must be {HEAD_DIM} '
                         f'(got width {A3} for {heads} heads)')
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise NotImplementedError('rope_attention_qkv: the CUDA path is '
                                  'forward-only (no backward kernel yet)')
    cos = cos.to(device=qkv.device, dtype=torch.float32).contiguous()
    sin = sin.to(device=qkv.device, dtype=torch.float32).contiguous()
    if cos.shape != (L, HEAD_DIM // 2) or sin.shape != cos.shape:
        raise ValueError(f'rope_attention_qkv: tables must be [{L}, {HEAD_DIM // 2}]')
    qkv = qkv.contiguous()
    out = torch.empty(B, L, heads * HEAD_DIM, dtype=qkv.dtype, device=qkv.device)
    lib = _build.load('rope_attention', _SIGNATURES)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = lib.hd_rope_attention_qkv(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
            B, L, heads, HEAD_DIM, float(scale), _DTYPES[qkv.dtype], stream)
    _build.check(code, 'rope_attention_qkv')
    launches += 1
    return out
