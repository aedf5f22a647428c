"""Plain float32 PyTorch reference of the HuDiff denoisers.

HuDiff-Ab (``AntiTFNet``: paired VH + VL on the 291-slot IMGT grid) and
HuDiff-Nb (``NanoAntiTFNet``: one heavy chain on 152 slots), written from
the published architecture (TencentAI4S/HuDiff, ``models/``) as plain
``torch`` operations on a flat dict of named parameters: no kernels, no
cache, no batching tricks. It imports nothing of the program.

The parameter names are those of the program's ``state_dict`` (the
benchmark makes one set of weights and hands the same dict to both). The
architecture, with every LayerNorm at eps 1e-6:

- ByteNet block over one chain, dilation d, kernel K, act relu or exact GELU:
  ``y = x + W2 act(LN3(conv_d(act(LN2(W1 act(LN1 x)))))``, the conv
  "same"-padded with zeros outside the chain, its weight laid out
  [out, K, in];
- towers of 6 blocks with dilations 1, 2, 4, 8, 16, 32 (powers of two
  cycling up to r = 128), d_h = d / 2; the pair model runs separate
  towers over the heavy (152) and light (139) rows;
- region embedder: embed(4) -> LN -> relu -> Linear -> LN -> relu; position
  embedder: x + sinusoidal PE, then x + Linear(GELU(Linear(x))) (d -> 2d -> d);
  side embedder (pair only): the chain types' embed(4) -> Linear -> LN ->
  relu -> Linear, each chain's row repeated over its slots;
- attention block: ``a = x + Attn(x); a = a + Attn_c(LN1 a);
  out = W_ff2 relu(W_ff1 LN2 a) + x`` with 8 heads of 64, the qkv
  projection head-major ([q_h | k_h | v_h] per head), rotary embeddings
  in rotate-half form (pairs (i, 32 + i), theta 10000) on q and k, softmax
  over every slot;
- pair: ``cat(emb + pos + side, pos, side)`` -> dual towers (768, relu) ->
  5 attention blocks -> LN -> decoder (23 logits); heavy: ``cat(emb + pos,
  pos)`` -> nano_conv tower (512, GELU) -> 5 attention blocks -> LN ->
  decoder.

``mm`` rounds the inputs of every matrix product and convolution (both
operands): the identity for the float32 reference, ``fp8_round`` for the
lower-precision control. TF32 is switched off inside ``no_tf32()``.

Dropout in a training step sits after each ByteNet block (p = the
configuration's ``dropout``) and on the position embedder's MLP output
(p = ``POS_MLP_DROPOUT``). Its masks are the program's draws: ``drop``
maps a site (``<tower>.blocks.<i>``, ``pos_encoder.mlp``) to the rows'
kept elements [B, ...] (bool), which the reference scales by 1 / (1 - p)
itself. Without ``drop`` (sampling) nothing drops.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
POS_MLP_DROPOUT = 0.5
Params = Dict[str, torch.Tensor]
Drop = Optional[Dict[str, torch.Tensor]]


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32, not TF32, inside the block (the flags
    restored after it)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (its largest
    magnitude onto 448), returned in float32; the gradient passes straight
    through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16, the program's compute type, returned in
    float32 (a witness of what that precision alone reads, not a control);
    the gradient passes straight through."""
    return t + (t.detach().to(torch.bfloat16).to(torch.float32) - t).detach()


def _ln(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p[f'{name}.weight'], p[f'{name}.bias'], LN_EPS)


def _linear(x: torch.Tensor, p: Params, name: str, mm: Callable) -> torch.Tensor:
    return F.linear(mm(x), mm(p[f'{name}.weight']), p[f'{name}.bias'])


def _act(x: torch.Tensor, name: str) -> torch.Tensor:
    return F.relu(x) if name == 'relu' else F.gelu(x)


def dropped(x: torch.Tensor, drop: Drop, site: str, p: float) -> torch.Tensor:
    """``x`` with the kept elements ``drop[site]`` scaled by 1 / (1 - p) and
    the others zero; ``x`` itself where no mask is given."""
    if not drop or site not in drop:
        return x
    return x * (drop[site].to(x.device, x.dtype) / (1.0 - p))


def dilations(n_layers: int, r: int):
    log2 = int(np.log2(r)) + 1
    return [2 ** (n % log2) for n in range(n_layers)]


def bytenet_block(x, p: Params, name: str, dilation: int, act: str, mm: Callable):
    h = _linear(_act(_ln(x, p, f'{name}.ln1'), act), p, f'{name}.fc1', mm)
    h = _act(_ln(h, p, f'{name}.ln2'), act)
    w = p[f'{name}.conv.weight']                                   # [out, K, in]
    pad = (w.shape[1] - 1) // 2 * dilation
    h = F.conv1d(mm(h).transpose(1, 2), mm(w).permute(0, 2, 1), p[f'{name}.conv.bias'],
                 padding=pad, dilation=dilation).transpose(1, 2)
    h = _act(_ln(h, p, f'{name}.ln3'), act)
    return x + _linear(h, p, f'{name}.fc2', mm)


def tower(x, p: Params, name: str, cfg: dict, n_layers: int, act: str, mm: Callable,
          drop: Drop = None):
    for i, d in enumerate(dilations(n_layers, cfg['r'])):
        x = bytenet_block(x, p, f'{name}.blocks.{i}', d, act, mm)
        x = dropped(x, drop, f'{name}.blocks.{i}', cfg['dropout'])
    return x


def sinusoidal(d: int, length: int, device) -> torch.Tensor:
    pos = np.arange(length, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-np.log(10000.0) / d))
    pe = np.zeros((length, d))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return torch.tensor(pe, dtype=torch.float32, device=device)


def rope(x: torch.Tensor) -> torch.Tensor:
    """Rotate [B, L, H, D] by slot, rotate-half pairs (i, D/2 + i)."""
    L, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / (10000.0 ** (np.arange(0, D, 2, dtype=np.float64) / D))
    ang = np.outer(np.arange(L, dtype=np.float64), freqs)
    c = torch.tensor(np.cos(ang), dtype=torch.float32, device=x.device)[:, None, :]
    s = torch.tensor(np.sin(ang), dtype=torch.float32, device=x.device)[:, None, :]
    a, b = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([a * c - b * s, a * s + b * c], dim=-1)


def attention(x, p: Params, name: str, heads: int, mm: Callable):
    B, L, _ = x.shape
    qkv = _linear(x, p, f'{name}.qkv', mm)
    hd = qkv.shape[-1] // 3 // heads
    g = qkv.reshape(B, L, heads, 3, hd)
    q, k, v = rope(g[:, :, :, 0]), rope(g[:, :, :, 1]), g[:, :, :, 2]
    s = torch.einsum('blhd,bmhd->bhlm', mm(q), mm(k)) / math.sqrt(hd)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum('bhlm,bmhd->blhd', mm(pr), mm(v)).reshape(B, L, heads * hd)
    return _linear(o, p, f'{name}.out', mm)


def attention_stack(x, p: Params, cfg: dict, mm: Callable):
    for i in range(cfg['cs_layers']):
        n = f'self_att.blocks.{i}'
        a = x + attention(x, p, f'{n}.attn', cfg['nhead'], mm)
        a = a + attention(_ln(a, p, f'{n}.norm1'), p, f'{n}.attn_c', cfg['nhead'], mm)
        h = F.relu(_linear(_ln(a, p, f'{n}.norm2'), p, f'{n}.ff1', mm))
        x = _linear(h, p, f'{n}.ff2', mm) + x
    return x


def position(region, p: Params, cfg: dict, mm: Callable, drop: Drop = None):
    e = p['region_encoder.embed.weight'][region]
    r = F.relu(_ln(e, p, 'region_encoder.ln1'))
    r = F.relu(_ln(_linear(r, p, 'region_encoder.fc', mm), p, 'region_encoder.ln2'))
    x = r + sinusoidal(r.shape[-1], r.shape[1], r.device)
    h = _linear(F.gelu(_linear(x, p, 'pos_encoder.mlp.fc1', mm)), p, 'pos_encoder.mlp.fc2', mm)
    return x + dropped(h, drop, 'pos_encoder.mlp', POS_MLP_DROPOUT)


def side(chain, p: Params, heavy_len: int, light_len: int, mm: Callable):
    h = p['side_encoder.embed.weight'][chain]                        # [B, 2, s]
    h = F.relu(_ln(_linear(h, p, 'side_encoder.fc1', mm), p, 'side_encoder.ln'))
    h = _linear(h, p, 'side_encoder.fc2', mm)
    return torch.cat([h[:, 0:1].expand(-1, heavy_len, -1),
                      h[:, 1:2].expand(-1, light_len, -1)], dim=1)


def pair_logits(p: Params, cfg: dict, tokens, region, chain, heavy_len: int,
                mm: Callable = identity, drop: Drop = None) -> torch.Tensor:
    """HuDiff-Ab: tokens [B, 291], region [B, 291], chain [B, 2] -> [B, 291, 23]."""
    emb = p['aa_embed.weight'][tokens]
    H = heavy_len
    act, n, dual = cfg['activation'], cfg['n_encoder_layers'], cfg['dual_layers']
    emb = torch.cat([tower(emb[:, :H], p, 'aa_encoder.h_tower', cfg, n, act, mm, drop),
                     tower(emb[:, H:], p, 'aa_encoder.l_tower', cfg, n, act, mm, drop)], dim=1)
    sd = side(chain, p, H, tokens.shape[1] - H, mm)
    pos = position(region, p, cfg, mm, drop)
    f = torch.cat([emb + pos + sd, pos, sd], dim=-1)
    f = torch.cat([tower(f[:, :H], p, 'dual_conv.h_tower', cfg, dual, 'relu', mm, drop),
                   tower(f[:, H:], p, 'dual_conv.l_tower', cfg, dual, 'relu', mm, drop)], dim=1)
    f = _ln(attention_stack(f, p, cfg, mm), p, 'last_norm')
    return _linear(f, p, 'decoder', mm)


def heavy_logits(p: Params, cfg: dict, tokens, region, chain=None,
                 mm: Callable = identity, drop: Drop = None) -> torch.Tensor:
    """HuDiff-Nb: tokens [B, 152], region [B, 152] -> [B, 152, 23]."""
    emb = tower(p['aa_embed.weight'][tokens], p, 'aa_encoder', cfg, cfg['n_encoder_layers'],
                cfg['activation'], mm, drop)
    pos = position(region, p, cfg, mm, drop)
    f = tower(torch.cat([emb + pos, pos], dim=-1), p, 'nano_conv', cfg, cfg['dual_layers'],
              'gelu', mm, drop)
    f = _ln(attention_stack(f, p, cfg, mm), p, 'last_norm')
    return _linear(f, p, 'decoder', mm)


def logits_fn(kind: str, heavy_len: int) -> Callable:
    """``fn(params, cfg, tokens, region, chain, mm, drop)`` for 'pair' or 'heavy'."""
    if kind == 'pair':
        return lambda p, cfg, t, r, c, mm=identity, drop=None: pair_logits(
            p, cfg, t, r, c, heavy_len, mm, drop)
    return lambda p, cfg, t, r, c=None, mm=identity, drop=None: heavy_logits(
        p, cfg, t, r, c, mm, drop)
