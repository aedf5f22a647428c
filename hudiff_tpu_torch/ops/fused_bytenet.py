"""K2 and K4: the ByteNet residual block, forward and backward.

Counterpart of hudiff_tpu/ops/pallas_bytenet.py (``bytenet_block_fused``,
its TPU kernels ``_fwd_kernel`` and ``_bwd_kernel`` and the custom VJP
around them, :380-407). The CUDA kernels are ``csrc/bytenet_block.cu`` (K2:
one call launches six, three LayerNorm row passes and three GEMMs) and
``csrc/bytenet_block_bwd.cu`` (K4: eleven launches, row passes, data- and
weight-gradient GEMMs and one fixed-order reduction); their headers say
what bounds them on an H100 and how the designs answer that.

Parameters: ``w1`` [H, D] and ``w2`` [D, H] as ``nn.Linear`` weights,
``wc`` [H, K, H] (out, tap, in: ``ops/bytenet.py::DilatedConv``); the
LayerNorm scales and biases and the three biases are f32.

``bytenet_block`` routes by the tensor's device alone: a CPU tensor takes
the plain versions, a CUDA tensor launches the kernels (or raises). When a
gradient is needed it goes through ``ByteNetBlockFn``, whose forward is K2
keeping p and q (the pre-LayerNorm Dense and conv outputs, in x's type) and
whose backward is K4, returning dx and the 12 parameter gradients in f32.
Otherwise it calls K2 alone, as the sampler does. ``launches`` and
``bwd_launches`` count the CUDA kernels K2's and K4's C entries report.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .norm import LN_EPS, activation, layer_norm

launches = 0
bwd_launches = 0

_SIGNATURES = {
    'hd_bytenet_block_fwd': [ctypes.c_void_p] * 18 + [ctypes.c_int] * 8
                            + [ctypes.c_void_p, ctypes.c_void_p],
}
_BWD_SIGNATURES = {
    'hd_bytenet_block_bwd': [ctypes.c_void_p] * 30 + [ctypes.c_int] * 8
                            + [ctypes.c_void_p, ctypes.c_void_p],
    'hd_bytenet_block_bwd_workspace': [ctypes.c_int] * 6,
}
_BWD_RESTYPES = {'hd_bytenet_block_bwd_workspace': ctypes.c_longlong}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {'relu': 0, 'gelu': 1}


def _reference_parts(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2, *,
                     dilation: int, activation_name: str):
    """(y, p, q) of the plain forward."""
    cd = x.dtype
    act = lambda t: activation(t, activation_name)  # noqa: E731
    a = act(layer_norm(x, g1, b1)).to(cd)
    p = (a.float() @ w1.to(cd).float().t() + c1.float()).to(cd)
    bb = act(layer_norm(p, g2, b2)).to(cd)
    pad = (wc.shape[1] - 1) // 2 * dilation
    q = F.conv1d(bb.float().transpose(1, 2), wc.to(cd).float().permute(0, 2, 1), cc.float(),
                 padding=pad, dilation=dilation).transpose(1, 2).to(cd)
    e = act(layer_norm(q, g3, b3)).to(cd)
    y = x.float() + (e.float() @ w2.to(cd).float().t() + c2.float())
    return y.to(cd), p, q


def bytenet_block_reference(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2,
                            *, dilation: int, activation_name: str) -> torch.Tensor:
    """Plain version of K2: LN(eps 1e-6) -> act -> matmul -> LN -> act ->
    dilated conv -> LN -> act -> matmul, plus x. Matmul and conv inputs are
    in x's type with f32 accumulation; p, q and y are rounded to x's type
    where the TPU kernel rounds them (ops/bytenet.py:144-155,
    pallas_bytenet.py:162-184)."""
    return _reference_parts(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2,
                            dilation=dilation, activation_name=activation_name)[0]


def _ln_parts(zf, g, b):
    """f32 LayerNorm with the fast variance: (affine output, normalized,
    1/sigma), as pallas_bytenet.py::_ln_parts (the variance clamped at 0, as
    the port's forward does)."""
    mu = zf.mean(dim=-1, keepdim=True)
    var = (zf * zf).mean(dim=-1, keepdim=True) - mu * mu
    inv = torch.rsqrt(var.clamp_min(0.0) + LN_EPS)
    n = (zf - mu) * inv
    return n * g.float() + b.float(), n, inv


def _ln_bwd(dn, n, inv):
    """dL/dz for n = normalize(z): (dn - mean(dn) - n mean(dn n)) / sigma."""
    m1 = dn.mean(dim=-1, keepdim=True)
    m2 = (dn * n).mean(dim=-1, keepdim=True)
    return (dn - m1 - n * m2) * inv


def _dact(u, name: str):
    """ReLU: u > 0; GELU: exact erf, cdf + u pdf."""
    if name == 'relu':
        return (u > 0).float()
    cdf = 0.5 * (1.0 + torch.erf(u * 0.7071067811865476))
    return cdf + u * torch.exp(-0.5 * u * u) * 0.3989422804014327


def _shift(t, s: int):
    """Rows l of [B, L, C] -> t[:, l + s], zero where l + s is outside [0, L)."""
    out = torch.zeros_like(t)
    L = t.shape[1]
    if abs(s) >= L:
        return out
    if s >= 0:
        out[:, :L - s] = t[:, s:]
    else:
        out[:, -s:] = t[:, :L + s]
    return out


def bytenet_block_backward_reference(x, p, q, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2,
                                     c2, dy, *, dilation: int, activation_name: str):
    """Plain version of K4: (dx, dg1, db1, dw1, dc1, dg2, db2, dwc, dcc, dg3,
    db3, dw2, dc2) from the saved x, p, q, by explicit formulas following
    pallas_bytenet.py::_bwd_kernel (:203-273) line by line, with its
    rounding points: a, bb, e, dq and dp in x's type (cd), every product of
    cd values accumulated in f32, dx rounded to cd, the parameter gradients
    f32 in the port's layouts."""
    cd = x.dtype
    act = lambda t: activation(t, activation_name)  # noqa: E731
    dact = lambda t: _dact(t, activation_name)  # noqa: E731
    rnd = lambda t: t.to(cd).float()  # noqa: E731
    w1c, wcc, w2c = (rnd(w) for w in (w1, wc, w2))
    dyf = rnd(dy)
    uh, un, inv1 = _ln_parts(x.float(), g1, b1)
    a = rnd(act(uh))
    vh, vn, inv2 = _ln_parts(p.float(), g2, b2)
    bb = rnd(act(vh))
    wh, wn, inv3 = _ln_parts(q.float(), g3, b3)
    e = rnd(act(wh))
    rows = (0, 1)

    # Dense_1 (w2): y = x + e w2^T + c2
    de = dyf @ w2c
    dw2 = torch.einsum('bld,blh->dh', dyf, e)
    dc2 = dyf.sum(rows)
    # LayerNorm_2 (g3, b3)
    dwh = de * dact(wh)
    dg3, db3 = (dwh * wn).sum(rows), dwh.sum(rows)
    dq = _ln_bwd(dwh * g3.float(), wn, inv3)
    dcc = dq.sum(rows)
    dqc = rnd(dq)
    # dilated conv: data grad reads dq shifted the opposite way per tap;
    # weight grad per tap = dq^T shifted bb
    K = wc.shape[1]
    dbb = torch.zeros_like(bb)
    dwc = torch.empty(wc.shape, dtype=torch.float32, device=x.device)
    for t in range(K):
        s = (t - (K - 1) // 2) * dilation
        dbb = dbb + _shift(dqc, -s) @ wcc[:, t, :]
        dwc[:, t, :] = torch.einsum('blo,bli->oi', dqc, _shift(bb, s))
    # LayerNorm_1 (g2, b2) + Dense_0 (w1)
    dvh = dbb * dact(vh)
    dg2, db2 = (dvh * vn).sum(rows), dvh.sum(rows)
    dp = _ln_bwd(dvh * g2.float(), vn, inv2)
    dc1 = dp.sum(rows)
    dpc = rnd(dp)
    da = dpc @ w1c
    dw1 = torch.einsum('blh,bld->hd', dpc, a)
    # LayerNorm_0 (g1, b1) + residual
    duh = da * dact(uh)
    dg1, db1 = (duh * un).sum(rows), duh.sum(rows)
    dx = (dyf + _ln_bwd(duh * g1.float(), un, inv1)).to(cd)
    return dx, dg1, db1, dw1, dc1, dg2, db2, dwc, dcc, dg3, db3, dw2, dc2


def _check(x, w1, wc, w2, activation_name: str, what: str):
    if x.device.type != 'cuda':
        raise ValueError(f'{what}: unsupported device {x.device}')
    if x.dtype not in _DTYPES:
        raise TypeError(f'{what}: dtype {x.dtype} not supported')
    if activation_name not in _ACTS:
        raise ValueError(f'{what}: unknown activation {activation_name!r}')
    B, L, D = x.shape
    H, K = w1.shape[0], wc.shape[1]
    if (w1.shape != (H, D) or wc.shape != (H, K, H) or w2.shape != (D, H)
            or D % 32 or H % 32 or K % 2 == 0):
        raise ValueError(f'{what}: unsupported shapes x {tuple(x.shape)}, '
                         f'w1 {tuple(w1.shape)}, wc {tuple(wc.shape)}, '
                         f'w2 {tuple(w2.shape)} (D, H multiples of 32, K odd)')
    return B, L, D, H, K


def _ready(t, dev, dtype):
    """``t`` on ``dev`` in ``dtype``, contiguous; no copy when it already is."""
    ok = t.device == dev and t.dtype == dtype and t.is_contiguous()
    return t if ok else t.to(device=dev, dtype=dtype).contiguous()


def _forward(x, params, dilation: int, activation_name: str, keep: bool):
    """K2 on a CUDA tensor, the plain version on a CPU one: (y, p, q) with
    p, q None unless ``keep`` (a forward alone lets q overwrite p)."""
    global launches
    if x.device.type == 'cpu':
        y, p, q = _reference_parts(x, *params, dilation=dilation,
                                   activation_name=activation_name)
        return (y, p, q) if keep else (y, None, None)
    g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2 = params
    B, L, D, H, K = _check(x, w1, wc, w2, activation_name, 'bytenet_block')
    dev, cd = x.device, x.dtype
    w1, wc, w2 = (_ready(t, dev, cd) for t in (w1, wc, w2))
    g1, b1, c1, g2, b2, cc, g3, b3, c2 = (
        _ready(t, dev, torch.float32) for t in (g1, b1, c1, g2, b2, cc, g3, b3, c2))
    x = x.contiguous()
    y = torch.empty_like(x)
    es = x.element_size()
    if keep:
        p, q = torch.empty(B, L, H, dtype=cd, device=dev), torch.empty(B, L, H, dtype=cd, device=dev)
        # scratch: act(LN1 x) [B, L, D]; act(LN2 p) then act(LN3 q) [B, L, H]
        scratch = torch.empty(B * L * (D + H), dtype=cd, device=dev)
        sa = scratch.data_ptr()
        sp, sq, s2 = p.data_ptr(), q.data_ptr(), sa + B * L * D * es
    else:
        p = q = None
        # scratch: act(LN1 x); p then q; act(LN2 p) then act(LN3 q)
        scratch = torch.empty(B * L * (D + 2 * H), dtype=cd, device=dev)
        sa = scratch.data_ptr()
        sp = sq = sa + B * L * D * es
        s2 = sp + B * L * H * es
    lib = _build.load('bytenet_block', _SIGNATURES)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.hd_bytenet_block_fwd(
            x.data_ptr(), g1.data_ptr(), b1.data_ptr(), w1.data_ptr(), c1.data_ptr(),
            g2.data_ptr(), b2.data_ptr(), wc.data_ptr(), cc.data_ptr(), g3.data_ptr(),
            b3.data_ptr(), w2.data_ptr(), c2.data_ptr(), sa, sp, sq, s2, y.data_ptr(),
            B, L, D, H, K, int(dilation), _ACTS[activation_name], _DTYPES[cd], stream,
            ctypes.addressof(launched))
    launches += launched.value
    _build.check(code, 'bytenet_block')
    return y, p, q


def bytenet_block_backward(x, p, q, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2, dy, *,
                           dilation: int, activation_name: str):
    """(dx, 12 f32 parameter gradients) of the block at (x, p, q) for the
    output gradient ``dy`` (cast to x's type first, as ``_fused_bwd``
    does): K4 on a CUDA tensor, the plain version on a CPU one."""
    global bwd_launches
    params = (g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2)
    dy = dy.to(x.dtype)
    if x.device.type == 'cpu':
        return bytenet_block_backward_reference(x, p, q, *params, dy, dilation=dilation,
                                                activation_name=activation_name)
    B, L, D, H, K = _check(x, w1, wc, w2, activation_name, 'bytenet_block_backward')
    dev, cd = x.device, x.dtype
    x, p, q, dy = (_ready(t, dev, cd) for t in (x, p, q, dy))
    if p.shape != (B, L, H) or q.shape != (B, L, H) or dy.shape != x.shape:
        raise ValueError('bytenet_block_backward: p, q must be [B, L, H] and dy like x')
    params = [_ready(t, dev, torch.float32) for t in params]
    grads = [torch.empty(t.shape, dtype=torch.float32, device=dev) for t in params]
    dx = torch.empty_like(x)
    lib = _build.load('bytenet_block_bwd', _BWD_SIGNATURES, _BWD_RESTYPES)
    act, dt = _ACTS[activation_name], _DTYPES[cd]
    nbytes = lib.hd_bytenet_block_bwd_workspace(B, L, D, H, K, dt)
    if nbytes <= 0:
        raise ValueError(f'bytenet_block_backward: unsupported shape B={B} L={L} D={D} '
                         f'H={H} K={K}')
    workspace = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.hd_bytenet_block_bwd(
            x.data_ptr(), p.data_ptr(), q.data_ptr(), *(t.data_ptr() for t in params),
            dy.data_ptr(), dx.data_ptr(), *(t.data_ptr() for t in grads),
            workspace.data_ptr(), B, L, D, H, K, int(dilation), act, dt, stream,
            ctypes.addressof(launched))
    bwd_launches += launched.value
    _build.check(code, 'bytenet_block_backward')
    return (dx, *grads)


class ByteNetBlockFn(torch.autograd.Function):
    """K2 forward keeping p and q, K4 backward (the custom VJP of
    pallas_bytenet.py:380-407)."""

    @staticmethod
    def forward(ctx, x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2, dilation,
                activation_name):
        params = (g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2)
        y, p, q = _forward(x, params, dilation, activation_name, keep=True)
        ctx.save_for_backward(x, p, q, *params)
        ctx.dilation, ctx.activation_name = dilation, activation_name
        return y

    @staticmethod
    def backward(ctx, dy):
        x, p, q, *params = ctx.saved_tensors
        grads = bytenet_block_backward(x, p, q, *params, dy, dilation=ctx.dilation,
                                       activation_name=ctx.activation_name)
        return (*grads, None, None)


def bytenet_block(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2, *,
                  dilation: int, activation_name: str) -> torch.Tensor:
    """ByteNet block y = x + W2 act(LN3 conv(act(LN2 (W1 act(LN1 x))))) on
    x [B, L, D] (one chain: the conv reads zeros outside [0, L))."""
    params = (g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return ByteNetBlockFn.apply(x, *params, dilation, activation_name)
    return _forward(x, params, dilation, activation_name, keep=False)[0]
