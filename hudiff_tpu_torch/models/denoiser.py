"""OA-ARDM denoisers in PyTorch: paired antibody (HuDiff-Ab) and nanobody
(HuDiff-Nb).

Counterpart of hudiff_tpu/models/denoiser.py:29-317. The two hot stages
run through the port's kernels, routed by the tensors' device alone:
RoPE attention (ops/fused_attention.py, K1) and the ByteNet blocks of every
tower (ops/fused_bytenet.py, K2). Everything else is plain torch.

``dtype`` is the compute type (bf16 on the card for sampling and
training). Parameters are created in f32; the sampler casts every >=2-D f32
parameter to bf16 once, while training keeps them f32 and casts per call,
so gradients reach the f32 parameters through the casts.

Training (``model.train()`` with autograd on): dropout is active where the
JAX package puts it, after each ByteNet block (p = ``cfg.dropout``) and in
the positional ``GatedMLP`` (p = 0.5), nowhere in ``SelfAttNet``. The
kernels' backwards are K3 (attention) and K4 (ByteNet block), through the
autograd Functions of ops/fused_attention.py and ops/fused_bytenet.py. On
the card all 24 tower blocks go through K2/K4, the 768/384 dual towers too:
the JAX package's ``conv_pallas_policy`` (hudiff_tpu/models/denoiser.py:
202-214) sends those to XLA in training only because of a TPU v5e
measurement, which says nothing about this card, so the port has no such
route.

Tensor parallelism (``tp_mesh``, a ``parallel.mesh.Mesh`` of tp > 1; the
JAX modules' field of that name): each ``SelfAttBlock`` holds this rank's
shard, as ``parallel.mesh.param_pspec`` cuts it. Each attention's qkv
projection keeps heads / tp whole heads of the head-major layout, runs
``rope_attention_qkv_tp`` (K1, K3 in its backward) on them, and its out
projection contracts them into a partial sum; the FFN's ``ff1`` keeps
dim_feedforward / tp of its units, ``ff2`` their rows. The Megatron
operators of parallel/megatron.py put one all-reduce after each row-split
projection and one on the gradient before each column-split one. The
towers, embedders, LayerNorms and decoder are replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import constants as C
from ..ops.bytenet import ByteNetStack
from ..ops.fused_attention import rope_attention_qkv_tp, tp_splits_heads
from ..ops.norm import LN_EPS
from ..ops.rope import rope_tables
from ..parallel.megatron import copy_to_tp, reduce_from_tp
from .embedders import PosEmbedder, RegionEmbedder, SideEmbedder, dense, norm


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    """Mirrors the ``model:`` section of configs/antibody_train.yml."""
    n_tokens: int = 23
    d_embedding: int = 256
    d_model: int = 256
    n_encoder_layers: int = 6
    aa_kernel_size: int = 7
    r: int = 128
    n_side: int = 3
    s_embedding: int = 4
    s_model: int = 256
    n_region: int = 7
    r_embedding: int = 4
    r_model: int = 256
    n_pos_model: int = 256
    max_len: int = C.PAIR_LEN
    sum_d_model: int = 768
    dual_layers: int = 6
    att_model: int = 512
    dim_feedforward: int = 256
    nhead: int = 8
    cs_layers: int = 5
    dropout: float = 0.2
    activation: str = 'gelu'

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> 'DenoiserConfig':
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def test_size(self) -> 'DenoiserConfig':
        """Tiny variant for fast tests (mirrors configs/antibody_test.yml)."""
        return dataclasses.replace(
            self, d_embedding=64, d_model=64, n_encoder_layers=1,
            aa_kernel_size=13, s_model=64, r_model=64, n_pos_model=64,
            sum_d_model=(3 * 64 if self.max_len == C.PAIR_LEN else 2 * 64),
            dual_layers=2, att_model=512, dim_feedforward=512, cs_layers=1)


def nano_config(**overrides) -> DenoiserConfig:
    """Default HuDiff-Nb config (configs/heavy_train.yml)."""
    base = dict(max_len=C.HEAVY_LEN, sum_d_model=512, dim_feedforward=256,
                dropout=0.5)
    base.update(overrides)
    return DenoiserConfig(**base)


def _tp(mesh) -> int:
    return 1 if mesh is None else mesh.tp


def column_dense(x: torch.Tensor, layer: nn.Linear, dtype, mesh) -> torch.Tensor:
    """``dense`` of a column-split projection: the input's gradient summed
    over the TP group (``dense`` itself without a mesh)."""
    return dense(x if mesh is None else copy_to_tp(x, mesh), layer, dtype)


def row_dense(x: torch.Tensor, layer: nn.Linear, dtype, mesh) -> torch.Tensor:
    """``dense`` of a row-split projection: the partial products summed
    over the TP group, then the (replicated) bias added once (``dense``
    itself without a mesh)."""
    if mesh is None:
        return dense(x, layer, dtype)
    y = reduce_from_tp(F.linear(x.to(dtype), layer.weight.to(dtype)), mesh)
    return y + layer.bias.to(dtype)


class RoPEAttention(nn.Module):
    """Multi-head self-attention with rotary embeddings over one merged
    head-major qkv projection ([q_h | k_h | v_h] per head); under
    ``tp_mesh`` this rank's heads / tp heads of it."""

    def __init__(self, d_model: int, att_model: int, nhead: int, length: int,
                 dtype=torch.float32, device=None, tp_mesh=None):
        super().__init__()
        tp = _tp(tp_mesh)
        if tp > 1 and not tp_splits_heads(nhead, 3 * att_model, tp_mesh):
            raise ValueError(f'tensor parallelism splits attention by head: {nhead} heads '
                             f'do not divide over tp={tp}')
        self.dtype, self.nhead, self.att_model = dtype, nhead, att_model
        self.tp_mesh = tp_mesh if tp > 1 else None
        head_dim = att_model // nhead
        self.scale = 1.0 / float(np.sqrt(head_dim))
        self.qkv = nn.Linear(d_model, 3 * att_model // tp, device=device)
        self.out = nn.Linear(att_model // tp, d_model, device=device)
        cos, sin = rope_tables(head_dim, length, device=device)
        self.register_buffer('cos', cos, persistent=False)
        self.register_buffer('sin', sin, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L = x.shape[1]
        qkv = column_dense(x, self.qkv, self.dtype, self.tp_mesh)
        out = rope_attention_qkv_tp(qkv, self.cos[:L], self.sin[:L], self.scale,
                                    self.nhead, self.tp_mesh, 3 * self.att_model)
        return row_dense(out, self.out, self.dtype, self.tp_mesh)


class SelfAttBlock(nn.Module):
    """Two attentions and a ReLU FFN; the FFN residual rejoins the block
    input, not the attention output."""

    def __init__(self, d_model: int, att_model: int, dim_feedforward: int,
                 nhead: int, length: int, dtype=torch.float32, device=None, tp_mesh=None):
        super().__init__()
        tp = _tp(tp_mesh)
        if dim_feedforward % tp:
            raise ValueError(f'dim_feedforward {dim_feedforward} does not divide over tp={tp}')
        self.dtype, self.tp_mesh = dtype, tp_mesh if tp > 1 else None
        attn = lambda: RoPEAttention(d_model, att_model, nhead, length,  # noqa: E731
                                     dtype=dtype, device=device, tp_mesh=tp_mesh)
        self.attn, self.attn_c = attn(), attn()
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.ff1 = nn.Linear(d_model, dim_feedforward // tp, device=device)
        self.ff2 = nn.Linear(dim_feedforward // tp, d_model, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        at = x + self.attn(x)
        at = at + self.attn_c(norm(at, self.norm1))
        h = F.relu(column_dense(norm(at, self.norm2), self.ff1, self.dtype, self.tp_mesh))
        return row_dense(h, self.ff2, self.dtype, self.tp_mesh) + x


class SelfAttNet(nn.Module):
    def __init__(self, d_model: int, att_model: int, dim_feedforward: int,
                 nhead: int, length: int, n_layers: int, dtype=torch.float32,
                 device=None, tp_mesh=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            SelfAttBlock(d_model, att_model, dim_feedforward, nhead, length,
                         dtype=dtype, device=device, tp_mesh=tp_mesh) for _ in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class SplitConvTowers(nn.Module):
    """Separate ByteNet towers over the heavy (152) and light (139) rows; a
    conv never reads across the boundary."""

    def __init__(self, n_layers: int, d_model: int, kernel_size: int, r: int,
                 activation: str, dropout: float, device=None):
        super().__init__()
        stack = lambda: ByteNetStack(n_layers, d_model, kernel_size, r,  # noqa: E731
                                     activation=activation, dropout=dropout,
                                     device=device)
        self.h_tower, self.l_tower = stack(), stack()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.h_tower(x[:, : C.HEAVY_LEN])
        l = self.l_tower(x[:, C.HEAVY_LEN:])
        return torch.cat([h, l], dim=1)


class AntiTFNet(nn.Module):
    """HuDiff-Ab paired denoiser: tokens [B, 291] -> logits [B, 291, 23].

    token embed -> split H/L ByteNet towers -> (+pos, +side) -> concat(3d)
    -> split dual conv towers -> joint RoPE self-attention -> LN -> decoder
    (the decoder always computes in f32). ``tp_mesh``: see the module's
    docstring."""

    def __init__(self, cfg: DenoiserConfig, dtype=torch.float32, device=None, tp_mesh=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        kw = dict(device=device)
        self.aa_embed = nn.Embedding(cfg.n_tokens, cfg.d_embedding, **kw)
        self.aa_encoder = SplitConvTowers(
            cfg.n_encoder_layers, cfg.d_model, cfg.aa_kernel_size, cfg.r,
            cfg.activation, cfg.dropout, **kw)
        self.side_encoder = SideEmbedder(cfg.n_side, cfg.s_embedding, cfg.s_model,
                                         C.HEAVY_LEN, C.LIGHT_LEN, dtype=dtype, **kw)
        self.region_encoder = RegionEmbedder(cfg.n_region, cfg.r_embedding,
                                             cfg.r_model, dtype=dtype, **kw)
        self.pos_encoder = PosEmbedder(cfg.n_pos_model, cfg.max_len, dtype=dtype, **kw)
        self.dual_conv = SplitConvTowers(
            cfg.dual_layers, cfg.sum_d_model, cfg.aa_kernel_size, cfg.r, 'relu',
            cfg.dropout, **kw)
        self.self_att = SelfAttNet(cfg.sum_d_model, cfg.att_model,
                                   cfg.dim_feedforward, cfg.nhead, cfg.max_len,
                                   cfg.cs_layers, dtype=dtype, tp_mesh=tp_mesh, **kw)
        self.last_norm = nn.LayerNorm(cfg.sum_d_model, eps=LN_EPS, **kw)
        self.decoder = nn.Linear(cfg.sum_d_model, cfg.n_tokens, **kw)

    def forward(self, tokens: torch.Tensor, region: torch.Tensor,
                chain_type: torch.Tensor) -> torch.Tensor:
        emb = self.aa_encoder(self.aa_embed(tokens).to(self.dtype))
        side = self.side_encoder(chain_type)
        pos = self.pos_encoder(self.region_encoder(region))
        feature = torch.cat([emb + pos + side, pos, side], dim=-1)
        feature = self.self_att(self.dual_conv(feature))
        feature = norm(feature, self.last_norm)
        return dense(feature, self.decoder, torch.float32)


class NanoAntiTFNet(nn.Module):
    """HuDiff-Nb heavy-only denoiser: tokens [B, 152] -> logits [B, 152, 23].

    token embed -> one ByteNet stack -> (+pos) -> concat(2d) -> GELU
    ``nano_conv`` stack -> RoPE self-attention -> LN -> decoder (f32). No
    side embedder: ``chain_type`` is accepted and unused. ``tp_mesh``: see
    the module's docstring."""

    def __init__(self, cfg: DenoiserConfig, dtype=torch.float32, device=None, tp_mesh=None):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        kw = dict(device=device)
        self.aa_embed = nn.Embedding(cfg.n_tokens, cfg.d_embedding, **kw)
        self.aa_encoder = ByteNetStack(cfg.n_encoder_layers, cfg.d_model,
                                       cfg.aa_kernel_size, cfg.r,
                                       activation=cfg.activation,
                                       dropout=cfg.dropout, **kw)
        self.region_encoder = RegionEmbedder(cfg.n_region, cfg.r_embedding,
                                             cfg.r_model, dtype=dtype, **kw)
        self.pos_encoder = PosEmbedder(cfg.n_pos_model, cfg.max_len, dtype=dtype, **kw)
        self.nano_conv = ByteNetStack(cfg.dual_layers, cfg.sum_d_model,
                                      cfg.aa_kernel_size, cfg.r, activation='gelu',
                                      dropout=cfg.dropout, **kw)
        self.self_att = SelfAttNet(cfg.sum_d_model, cfg.att_model,
                                   cfg.dim_feedforward, cfg.nhead, cfg.max_len,
                                   cfg.cs_layers, dtype=dtype, tp_mesh=tp_mesh, **kw)
        self.last_norm = nn.LayerNorm(cfg.sum_d_model, eps=LN_EPS, **kw)
        self.decoder = nn.Linear(cfg.sum_d_model, cfg.n_tokens, **kw)

    def forward(self, tokens: torch.Tensor, region: torch.Tensor,
                chain_type: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.aa_encoder(self.aa_embed(tokens).to(self.dtype))
        pos = self.pos_encoder(self.region_encoder(region))
        feature = torch.cat([emb + pos, pos], dim=-1)
        feature = self.self_att(self.nano_conv(feature))
        feature = norm(feature, self.last_norm)
        return dense(feature, self.decoder, torch.float32)
