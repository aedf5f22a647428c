"""K1, K3, K5, K6 and K7: the fused attention kernels, forward and backward.

Counterpart of hudiff_tpu/ops/pallas_attention.py (all of it except the
tensor-parallel ``rope_attention_qkv_tp``, which waits for the port's
parallelism):

- ``rope_attention_qkv``: RoPE attention over a head-major merged qkv
  projection; K1 forward (``_rope_fwd_kernel_qkv``), K3 backward
  (``_rope_bwd_kernel_qkv``), the custom VJP of :320-337;
- ``rope_attention``: the same on separate q, k, v; K5 forward
  (``_rope_fwd_kernel``), K6 backward (``_rope_bwd_kernel``), the custom
  VJP of :171-188;
- ``fused_attention`` ([B, H, L, D]) and ``attention`` ([B, L, H, D]):
  softmax attention without RoPE, forward only; K7 (``_attn_kernel``).

The CUDA kernels are ``csrc/rope_attention.cu`` (K1, K5 and K7: one
forward, three layouts) and ``csrc/rope_attention_bwd.cu`` (K3 and K6: one
two-launch backward, two layouts); their headers say what bounds them on an
H100 and how their designs answer that.

Every wrapper routes by the tensor's device alone: a CPU tensor takes the
plain versions below, a CUDA tensor launches the kernels (or raises). When
a gradient is needed ``rope_attention_qkv`` and ``rope_attention`` go
through ``torch.autograd.Function``s whose backwards are K3 and K6;
otherwise (``torch.inference_mode()``, ``no_grad``, or inputs that need no
grad) they call the forward kernel directly. K7 has no backward: a CUDA
input that needs a gradient raises. Launch counters: ``launches`` (K1),
``bwd_launches`` (the kernels K3's C entry reports, two per call),
``rope_launches`` (K5), ``rope_bwd_launches`` (K6, two per call) and
``attention_launches`` (K7).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .rope import apply_rope, apply_rope_inverse

HEAD_DIM = 64
launches = 0
bwd_launches = 0
rope_launches = 0
rope_bwd_launches = 0
attention_launches = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    'hd_rope_attention_qkv': [_P] * 4 + [_I] * 4 + [_F, _I, _P],
    'hd_rope_attention': [_P] * 6 + [_I] * 4 + [_F, _I, _P],
    'hd_attention': [_P] * 4 + [_I] * 10 + [_F, _I, _P],
}
_BWD_SIGNATURES = {
    'hd_rope_attention_qkv_bwd': [_P] * 6 + [_I] * 4 + [_F, _I, _P, _P],
    'hd_rope_attention_bwd': [_P] * 10 + [_I] * 4 + [_F, _I, _P, _P],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def split_qkv_heads(qkv: torch.Tensor, heads: int):
    """Head-major merged qkv [B, L, H*3*D] -> (q, k, v) each [B, L, H*D]."""
    B, L, A3 = qkv.shape
    hd = A3 // 3 // heads
    g = qkv.reshape(B, L, heads, 3, hd)
    return tuple(g[:, :, :, i].reshape(B, L, heads * hd) for i in range(3))


def merge_qkv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    heads: int) -> torch.Tensor:
    """(q, k, v) each [..., H*D] -> head-major merged qkv [..., H*3*D]
    (pallas_attention.py:215-221, for any leading dimensions)."""
    *lead, A = q.shape
    hd = A // heads
    return torch.stack([t.reshape(*lead, heads, hd) for t in (q, k, v)],
                       dim=-2).reshape(*lead, 3 * A)


# -- plain versions -----------------------------------------------------------

def rope_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             cos: torch.Tensor, sin: torch.Tensor, scale: float,
                             heads: int) -> torch.Tensor:
    """Plain version of K5 (pallas_attention.py:425-432): q/k rotated in
    f32 and rounded to their type, scores of input-type values accumulated
    in f32 and scaled after the product, softmax over all L, P cast to v's
    type, P v accumulated in f32. q, k, v [B, L, H*D]; returns [B, L, H*D]
    in v's type."""
    B, L, A = q.shape
    D = A // heads
    qh = apply_rope(q.reshape(B, L, heads, D), cos, sin)
    kh = apply_rope(k.reshape(B, L, heads, D), cos, sin)
    vh = v.reshape(B, L, heads, D)
    logits = torch.einsum('blhd,bmhd->bhlm', qh.float(), kh.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum('bhlm,bmhd->blhd', probs.float(), vh.float())
    return out.reshape(B, L, A).to(v.dtype)


def rope_attention_qkv_reference(qkv: torch.Tensor, cos: torch.Tensor,
                                 sin: torch.Tensor, scale: float,
                                 heads: int) -> torch.Tensor:
    """Plain version of K1: ``rope_attention_reference`` on the split
    head-major qkv [B, L, H*3*D]; returns [B, L, H*D]."""
    return rope_attention_reference(*split_qkv_heads(qkv, heads), cos, sin, scale, heads)


def rope_attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      cos: torch.Tensor, sin: torch.Tensor,
                                      do: torch.Tensor, scale: float, heads: int):
    """Plain version of K6: the gradients of ``rope_attention`` with
    respect to q, k and v, by explicit formulas in the TPU kernel's order
    and rounding (pallas_attention.py:100-133): q/k rotated in f32 and
    rounded to the input type; products of input-type values accumulated
    in f32; P recomputed in f32, ``ph``, ``ds`` and ``do`` in the input
    type; dq/dk scaled, rotated back in f32 and rounded. Returns (dq, dk,
    dv), each [B, L, H*D] in q's type."""
    cd = q.dtype
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
    return tuple(t.reshape(B, L, A) for t in (dq, dk, dv.to(cd)))


def rope_attention_qkv_backward_reference(qkv: torch.Tensor, cos: torch.Tensor,
                                          sin: torch.Tensor, do: torch.Tensor,
                                          scale: float, heads: int) -> torch.Tensor:
    """Plain version of K3 (pallas_attention.py:248-284, the same formulas
    as K6 on the split qkv): returns head-major dqkv [B, L, H*3*D] in
    qkv's type."""
    grads = rope_attention_backward_reference(*split_qkv_heads(qkv, heads), cos, sin, do,
                                              scale, heads)
    return merge_qkv_heads(*grads, heads)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """Plain version of K7 (pallas_attention.py:481-485): softmax(q k^T *
    scale) v over [B, L, H, D], scores of input-type values accumulated in
    f32, P cast to v's type, P v accumulated in f32; returns [B, L, H, D]
    in v's type."""
    logits = torch.einsum('blhd,bmhd->bhlm', q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum('bhlm,bmhd->blhd', probs.float(), v.float()).to(v.dtype)


# -- the kernels' wrappers ----------------------------------------------------

def _check_cuda(x: torch.Tensor, width: int, what: str) -> None:
    if x.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {x.device}')
    if x.dtype not in _DTYPES:
        raise TypeError(f'{what}: dtype {x.dtype} not supported')
    if x.shape[-1] != width:
        raise ValueError(f'{what}: head dim must be {HEAD_DIM} (got width {x.shape[-1]}, '
                         f'expected {width})')


def _check_same(ts, what: str) -> None:
    first = ts[0]
    for t in ts[1:]:
        if t.shape != first.shape or t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f'{what}: q, k, v (and do) must share shape, dtype and device')


def _tables(cos, sin, x, L, what):
    cos = cos.to(device=x.device, dtype=torch.float32).contiguous()
    sin = sin.to(device=x.device, dtype=torch.float32).contiguous()
    if cos.shape != (L, HEAD_DIM // 2) or sin.shape != cos.shape:
        raise ValueError(f'{what}: tables must be [{L}, {HEAD_DIM // 2}]')
    return cos, sin


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _forward(qkv, cos, sin, scale, heads):
    """K1 on a CUDA tensor, or the plain version on a CPU one."""
    global launches
    if qkv.device.type == 'cpu':
        return rope_attention_qkv_reference(qkv, cos, sin, scale, heads)
    _check_cuda(qkv, heads * 3 * HEAD_DIM, 'rope_attention_qkv')
    B, L, _ = qkv.shape
    cos, sin = _tables(cos, sin, qkv, L, 'rope_attention_qkv')
    qkv = qkv.contiguous()
    out = torch.empty(B, L, heads * HEAD_DIM, dtype=qkv.dtype, device=qkv.device)
    lib = _build.load('rope_attention', _SIGNATURES)
    with torch.cuda.device(qkv.device):
        code = lib.hd_rope_attention_qkv(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
            B, L, heads, HEAD_DIM, float(scale), _DTYPES[qkv.dtype], _stream(qkv))
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
    _check_cuda(qkv, heads * 3 * HEAD_DIM, 'rope_attention_qkv_backward')
    B, L, _ = qkv.shape
    if do.shape != (B, L, heads * HEAD_DIM) or do.device != qkv.device:
        raise ValueError(f'rope_attention_qkv_backward: do must be [{B}, {L}, '
                         f'{heads * HEAD_DIM}] on {qkv.device}')
    cos, sin = _tables(cos, sin, qkv, L, 'rope_attention_qkv_backward')
    qkv, do = qkv.contiguous(), do.contiguous()
    dqkv = torch.empty_like(qkv)
    stats = torch.empty(3 * B * heads * L, dtype=torch.float32, device=qkv.device)
    lib = _build.load('rope_attention_bwd', _BWD_SIGNATURES)
    launched = ctypes.c_int(0)
    with torch.cuda.device(qkv.device):
        code = lib.hd_rope_attention_qkv_bwd(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), do.data_ptr(),
            dqkv.data_ptr(), stats.data_ptr(), B, L, heads, HEAD_DIM, float(scale),
            _DTYPES[qkv.dtype], _stream(qkv), ctypes.addressof(launched))
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


def _rope_forward(q, k, v, cos, sin, scale, heads):
    """K5 on CUDA tensors, or the plain version on CPU ones."""
    global rope_launches
    if q.device.type == 'cpu':
        return rope_attention_reference(q, k, v, cos, sin, scale, heads)
    _check_same((q, k, v), 'rope_attention')
    _check_cuda(q, heads * HEAD_DIM, 'rope_attention')
    B, L, _ = q.shape
    cos, sin = _tables(cos, sin, q, L, 'rope_attention')
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _build.load('rope_attention', _SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.hd_rope_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            out.data_ptr(), B, L, heads, HEAD_DIM, float(scale), _DTYPES[q.dtype], _stream(q))
    _build.check(code, 'rope_attention')
    rope_launches += 1
    return out


def rope_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            cos: torch.Tensor, sin: torch.Tensor, do: torch.Tensor,
                            scale: float, heads: int):
    """(dq, dk, dv), each [B, L, heads*64], for the output gradient ``do``
    (cast to q's type first, as ``_fused_bwd`` does): K6 on CUDA tensors,
    the plain version on CPU ones."""
    global rope_bwd_launches
    do = do.to(q.dtype)
    if q.device.type == 'cpu':
        return rope_attention_backward_reference(q, k, v, cos, sin, do, scale, heads)
    _check_same((q, k, v, do), 'rope_attention_backward')
    _check_cuda(q, heads * HEAD_DIM, 'rope_attention_backward')
    B, L, _ = q.shape
    cos, sin = _tables(cos, sin, q, L, 'rope_attention_backward')
    q, k, v, do = (t.contiguous() for t in (q, k, v, do))
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty(3 * B * heads * L, dtype=torch.float32, device=q.device)
    lib = _build.load('rope_attention_bwd', _BWD_SIGNATURES)
    launched = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        code = lib.hd_rope_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            B, L, heads, HEAD_DIM, float(scale), _DTYPES[q.dtype], _stream(q),
            ctypes.addressof(launched))
    rope_bwd_launches += launched.value
    _build.check(code, 'rope_attention_backward')
    return dq, dk, dv


class RopeAttention(torch.autograd.Function):
    """K5 forward, K6 backward (the custom VJP of pallas_attention.py:171-188).
    Saves q, k and v: cos/sin are constants."""

    @staticmethod
    def forward(ctx, q, k, v, cos, sin, scale, heads):
        ctx.save_for_backward(q, k, v)
        ctx.cos, ctx.sin, ctx.scale, ctx.heads = cos, sin, scale, heads
        return _rope_forward(q, k, v, cos, sin, scale, heads)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = rope_attention_backward(q, k, v, ctx.cos, ctx.sin, do, ctx.scale,
                                             ctx.heads)
        return dq, dk, dv, None, None, None, None


def rope_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, scale: float, heads: int) -> torch.Tensor:
    """RoPE(q, k) then softmax(q k^T * scale) v, head-blocked: q, k, v
    [B, L, heads*64] (the raw projection outputs), [L, 32] f32 rotate-half
    tables; returns [B, L, heads*64] in v's type."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return RopeAttention.apply(q, k, v, cos, sin, scale, heads)
    return _rope_forward(q, k, v, cos, sin, scale, heads)


def _attention_kernel(q, k, v, scale, heads, L, strides, what):
    """K7 on q, k, v of one shape, made contiguous; ``strides`` (batch,
    row, head) in elements, the same for the output."""
    global attention_launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f'{what}: forward only (no VJP, as in the JAX package); '
                           'use rope_attention in differentiated code')
    _check_same((q, k, v), what)
    _check_cuda(q, HEAD_DIM, what)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lib = _build.load('rope_attention', _SIGNATURES)
    with torch.cuda.device(q.device):
        code = lib.hd_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                q.shape[0], L, heads, HEAD_DIM, *strides, *strides,
                                float(scale), _DTYPES[q.dtype], _stream(q))
    _build.check(code, what)
    attention_launches += 1
    return out


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over q, k, v [B, H, L, 64]; returns
    [B, H, L, 64] in v's type. Forward only: K7 on CUDA tensors, the plain
    version on CPU ones."""
    if q.device.type == 'cpu':
        t = lambda x: x.transpose(1, 2)  # noqa: E731
        return t(attention_reference(t(q), t(k), t(v), scale))
    _, H, L, D = q.shape
    return _attention_kernel(q, k, v, scale, H, L, (H * L * D, D, L * D), 'fused_attention')


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention over [B, L, H, 64] inputs (RoPE applied by the caller) ->
    [B, L, H, 64]. Forward only: K7 on CUDA tensors, reading this layout
    through its strides (the JAX package transposes to [B, H, L, D]; the
    result is the same), the plain version on CPU ones."""
    if q.device.type == 'cpu':
        return attention_reference(q, k, v, scale)
    _, L, H, D = q.shape
    return _attention_kernel(q, k, v, scale, H, L, (L * H * D, H * D, D), 'attention')


def attention_matmul_flops(B: int, L: int, heads: int, head_dim: int,
                           backward: bool = False) -> float:
    """Executed matrix-unit FLOPs of one fused RoPE-attention call, as the
    JAX package counts them (pallas_attention.py:500-515). Forward per
    head: 2 RoPE rotation products ([L,D]@[D,D]) + QK^T + PV. Backward per
    head: 4 rotations (q/k recompute + dq/dk inverse) + 5 [L,L,D] products
    (st recompute, dv, dp, dq, dk). ``backward=True`` returns the total of
    a forward and backward pass (the forward runs again under grad)."""
    rot = 2.0 * L * head_dim * head_dim
    big = 2.0 * L * L * head_dim
    fwd = B * heads * (2 * rot + 2 * big)
    if not backward:
        return fwd
    bwd = B * heads * (4 * rot + 5 * big)
    return fwd + bwd
