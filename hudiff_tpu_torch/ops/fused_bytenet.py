"""K2: the ByteNet residual block forward as one call.

Counterpart of hudiff_tpu/ops/pallas_bytenet.py (``bytenet_block_fused`` and
its TPU kernel ``_fwd_kernel``). The CUDA kernels are
``csrc/bytenet_block.cu``: one call launches six (three LayerNorm row
passes and three GEMMs: Dense, the dilated conv, Dense + residual); its
header says what bounds them on an H100 and how the split answers that.

Parameters: ``w1`` [H, D] and ``w2`` [D, H] as ``nn.Linear`` weights,
``wc`` [H, K, H] (out, tap, in: ``ops/bytenet.py::DilatedConv``); the
LayerNorm scales and biases and the three biases are f32.

``bytenet_block`` routes by the tensor's device alone: a CPU tensor takes
the plain version, a CUDA tensor launches the kernels (or raises).
``launches`` counts the CUDA kernels launched, as the C entry reports them
(six for each call that succeeds).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .norm import activation, layer_norm

launches = 0

_SIGNATURES = {
    'hd_bytenet_block_fwd': [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8
                            + [ctypes.c_void_p, ctypes.c_void_p],
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {'relu': 0, 'gelu': 1}


def bytenet_block_reference(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2,
                            *, dilation: int, activation_name: str) -> torch.Tensor:
    """Plain version: LN(eps 1e-6) -> act -> matmul -> LN -> act -> dilated
    conv -> LN -> act -> matmul, plus x. Matmul and conv inputs are in x's
    type with f32 accumulation; p, q and y are rounded to x's type where the
    TPU kernel rounds them (ops/bytenet.py:144-155, pallas_bytenet.py:162-184)."""
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
    return y.to(cd)


def bytenet_block(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2, *,
                  dilation: int, activation_name: str) -> torch.Tensor:
    """ByteNet block y = x + W2 act(LN3 conv(act(LN2 (W1 act(LN1 x))))) on
    x [B, L, D] (one chain: the conv reads zeros outside [0, L))."""
    global launches
    if x.device.type == 'cpu':
        return bytenet_block_reference(x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3,
                                       w2, c2, dilation=dilation,
                                       activation_name=activation_name)
    if x.device.type != 'cuda':
        raise ValueError(f'bytenet_block: unsupported device {x.device}')
    if x.dtype not in _DTYPES:
        raise TypeError(f'bytenet_block: dtype {x.dtype} not supported')
    if activation_name not in _ACTS:
        raise ValueError(f'bytenet_block: unknown activation {activation_name!r}')
    B, L, D = x.shape
    H, K = w1.shape[0], wc.shape[1]
    if (w1.shape != (H, D) or wc.shape != (H, K, H) or w2.shape != (D, H)
            or D % 32 or H % 32 or K % 2 == 0):
        raise ValueError(f'bytenet_block: unsupported shapes x {tuple(x.shape)}, '
                         f'w1 {tuple(w1.shape)}, wc {tuple(wc.shape)}, '
                         f'w2 {tuple(w2.shape)} (D, H multiples of 32, K odd)')
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, g1, b1, w1, c1, g2, b2, wc, cc, g3, b3, w2, c2)):
        raise NotImplementedError('bytenet_block: the CUDA path is forward-only '
                                  '(no backward kernel yet)')
    dev, cd = x.device, x.dtype

    def ready(t, dtype):  # no copy when already on the card in the right form
        ok = t.device == dev and t.dtype == dtype and t.is_contiguous()
        return t if ok else t.to(device=dev, dtype=dtype).contiguous()

    w1, wc, w2 = (ready(t, cd) for t in (w1, wc, w2))
    g1, b1, c1, g2, b2, cc, g3, b3, c2 = (
        ready(t, torch.float32) for t in (g1, b1, c1, g2, b2, cc, g3, b3, c2))
    x = x.contiguous()
    y = torch.empty_like(x)
    # scratch: act(LN1 x) [B, L, D]; p then q [B, L, H]; act(LN2 p) then act(LN3 q)
    scratch = torch.empty(B * L * (D + 2 * H), dtype=cd, device=dev)
    sa = scratch.data_ptr()
    s1 = sa + B * L * D * x.element_size()
    s2 = s1 + B * L * H * x.element_size()
    lib = _build.load('bytenet_block', _SIGNATURES)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.hd_bytenet_block_fwd(
            x.data_ptr(), g1.data_ptr(), b1.data_ptr(), w1.data_ptr(), c1.data_ptr(),
            g2.data_ptr(), b2.data_ptr(), wc.data_ptr(), cc.data_ptr(), g3.data_ptr(),
            b3.data_ptr(), w2.data_ptr(), c2.data_ptr(), sa, s1, s2, y.data_ptr(),
            B, L, D, H, K, int(dilation), _ACTS[activation_name], _DTYPES[cd], stream,
            ctypes.addressof(launched))
    launches += launched.value
    _build.check(code, 'bytenet_block')
    return y
