"""K1 and K3: fused RoPE attention over a head-major merged qkv projection,
forward and backward.

Counterpart of hudiff_tpu/ops/pallas_attention.py (``rope_attention_qkv``,
its TPU kernels ``_rope_fwd_kernel_qkv`` and ``_rope_bwd_kernel_qkv`` and
the custom VJP around them, :320-337). The CUDA kernels are
``csrc/rope_attention.cu`` (K1) and ``csrc/rope_attention_bwd.cu`` (K3);
their headers say what bounds them on an H100 and how their designs
answer that.

``rope_attention_qkv`` routes by the tensor's device alone: a CPU tensor
takes the plain versions below, a CUDA tensor launches the kernels (or
raises). When a gradient is needed it goes through ``RopeAttentionQKV``, a
``torch.autograd.Function`` whose forward is K1 and whose backward is K3;
otherwise (``torch.inference_mode()``, ``no_grad``, or an input that needs
no grad) it calls K1 directly. ``launches`` counts K1 launches and
``bwd_launches`` the kernels K3's C entry reports (two per call).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .rope import apply_rope, apply_rope_inverse

HEAD_DIM = 64
launches = 0
bwd_launches = 0

_SIGNATURES = {
    'hd_rope_attention_qkv': [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_int, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    'hd_rope_attention_qkv_bwd': [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p],
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
    """Plain version of K1: split, rotate q/k in f32, scores of input-type
    values accumulated in f32 and scaled after the product, softmax over
    all L, P cast to v's type, P v accumulated in f32. Returns [B, L, H*D]
    in v's type (pallas_attention.py:425-432)."""
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


def rope_attention_qkv_backward_reference(qkv: torch.Tensor, cos: torch.Tensor,
                                          sin: torch.Tensor, do: torch.Tensor,
                                          scale: float, heads: int) -> torch.Tensor:
    """Plain version of K3: the gradient of ``rope_attention_qkv`` with
    respect to qkv, by explicit formulas in the TPU kernel's order and
    rounding (pallas_attention.py:248-284): q/k rotated in f32 and rounded
    to the input type; products of input-type values accumulated in f32;
    P recomputed in f32, ``ph``, ``ds`` and ``do`` in the input type; dq/dk
    scaled, rotated back in f32 and rounded. Returns head-major dqkv
    [B, L, H*3*D] in qkv's type."""
    cd = qkv.dtype
    q, k, v = split_qkv_heads(qkv, heads)
    B, L, A = q.shape
    D = A // heads
    qh = apply_rope(q.reshape(B, L, heads, D), cos, sin).float()
    kh = apply_rope(k.reshape(B, L, heads, D), cos, sin).float()
    vh = v.reshape(B, L, heads, D).float()
    doh = do.to(cd).reshape(B, L, heads, D).float()
    st = torch.einsum('blhd,bmhd->bhlm', qh, kh) * scale
    p = torch.softmax(st, dim=-1)
    ph = p.to(cd).float()
    dv = torch.einsum('bhlm,blhd->bmhd', ph, doh)
    dp = torch.einsum('blhd,bmhd->bhlm', doh, vh)
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(cd).float()
    dq = torch.einsum('bhlm,bmhd->blhd', ds, kh) * scale
    dk = torch.einsum('bhlm,blhd->bmhd', ds, qh) * scale
    dq = apply_rope_inverse(dq, cos, sin).to(cd)
    dk = apply_rope_inverse(dk, cos, sin).to(cd)
    return torch.stack([dq, dk, dv.to(cd)], dim=3).reshape(B, L, 3 * A)


def _check_cuda(qkv: torch.Tensor, heads: int, what: str) -> None:
    if qkv.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {qkv.device}')
    if qkv.dtype not in _DTYPES:
        raise TypeError(f'{what}: dtype {qkv.dtype} not supported')
    if qkv.shape[-1] != heads * 3 * HEAD_DIM:
        raise ValueError(f'{what}: head dim must be {HEAD_DIM} '
                         f'(got width {qkv.shape[-1]} for {heads} heads)')


def _tables(cos, sin, qkv, what):
    cos = cos.to(device=qkv.device, dtype=torch.float32).contiguous()
    sin = sin.to(device=qkv.device, dtype=torch.float32).contiguous()
    if cos.shape != (qkv.shape[1], HEAD_DIM // 2) or sin.shape != cos.shape:
        raise ValueError(f'{what}: tables must be [{qkv.shape[1]}, {HEAD_DIM // 2}]')
    return cos, sin


def _forward(qkv, cos, sin, scale, heads):
    """K1 on a CUDA tensor, or the plain version on a CPU one."""
    global launches
    if qkv.device.type == 'cpu':
        return rope_attention_qkv_reference(qkv, cos, sin, scale, heads)
    _check_cuda(qkv, heads, 'rope_attention_qkv')
    B, L, _ = qkv.shape
    cos, sin = _tables(cos, sin, qkv, 'rope_attention_qkv')
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


def rope_attention_qkv_backward(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                                do: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """dqkv [B, L, heads*3*64] for the output gradient ``do`` [B, L,
    heads*64] (cast to qkv's type first, as ``_fused_qkv_bwd`` does): K3 on
    a CUDA tensor, the plain version on a CPU one."""
    global bwd_launches
    do = do.to(qkv.dtype)
    if qkv.device.type == 'cpu':
        return rope_attention_qkv_backward_reference(qkv, cos, sin, do, scale, heads)
    _check_cuda(qkv, heads, 'rope_attention_qkv_backward')
    B, L, _ = qkv.shape
    if do.shape != (B, L, heads * HEAD_DIM) or do.device != qkv.device:
        raise ValueError(f'rope_attention_qkv_backward: do must be [{B}, {L}, '
                         f'{heads * HEAD_DIM}] on {qkv.device}')
    cos, sin = _tables(cos, sin, qkv, 'rope_attention_qkv_backward')
    qkv, do = qkv.contiguous(), do.contiguous()
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(3 * B * heads * L, dtype=torch.float32, device=qkv.device)
    lib = _build.load('rope_attention_bwd', _BWD_SIGNATURES)
    launched = ctypes.c_int(0)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        code = lib.hd_rope_attention_qkv_bwd(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), do.data_ptr(),
            dqkv.data_ptr(), stats.data_ptr(), B, L, heads, HEAD_DIM, float(scale),
            _DTYPES[qkv.dtype], stream, ctypes.addressof(launched))
    bwd_launches += launched.value
    _build.check(code, 'rope_attention_qkv_backward')
    return dqkv


class RopeAttentionQKV(torch.autograd.Function):
    """K1 forward, K3 backward (the custom VJP of pallas_attention.py:320-337).
    Saves qkv only: cos/sin are constants."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, scale, heads):
        ctx.save_for_backward(qkv)
        ctx.cos, ctx.sin, ctx.scale, ctx.heads = cos, sin, scale, heads
        return _forward(qkv, cos, sin, scale, heads)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        dqkv = rope_attention_qkv_backward(qkv, ctx.cos, ctx.sin, do, ctx.scale, ctx.heads)
        return dqkv, None, None, None, None


def rope_attention_qkv(qkv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                       scale: float, heads: int) -> torch.Tensor:
    """RoPE attention on head-major merged qkv [B, L, heads*3*64] with
    [L, 32] f32 rotate-half tables; returns [B, L, heads*64]."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return RopeAttentionQKV.apply(qkv, cos, sin, scale, heads)
    return _forward(qkv, cos, sin, scale, heads)
