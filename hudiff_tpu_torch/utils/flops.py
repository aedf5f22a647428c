"""FLOP counts of the denoisers, for TFLOP/s and MFU readings.

Counterpart of hudiff_tpu/utils/flops.py. The JAX package adds the matmul
FLOPs run inside its Pallas kernels to XLA's cost analysis (which counts
~0 for a custom call); the port has no cost analysis, so it counts both
halves by hand:

- ``denoiser_kernel_flops``: the matmul FLOPs inside the port's kernels
  for one evaluation, from the kernels' own counters
  (``ops/fused_attention.py::attention_matmul_flops``,
  ``ops/fused_bytenet.py::block_matmul_flops``). Where the routing agrees
  it equals JAX's ``denoiser_pallas_flops``. It does not agree in one
  place: the JAX package sends the 768/384 dual towers of the pair model to
  XLA on training (non-deterministic) traces (``conv_pallas_policy``, a
  TPU v5e measurement), while the port runs every tower block through
  K2/K4 on the card, so the port's training count is JAX's plus those
  towers' ``block_matmul_flops``. The port's routing depends on the
  device alone, so ``deterministic`` changes nothing here.
- ``denoiser_model_flops``: the whole model's matmuls (every projection,
  the embedders' and the decoder's, the conv taps that read the sequence,
  and the attention products; ``denoiser_stage_flops`` by stage), the
  count XLA's cost analysis makes of the JAX model's forward less its
  elementwise operations (full-width Ab forward at B = 1: 17.99 GFLOP
  against XLA's 18.19 on the CPU).

``H100_SXM_BF16_DENSE_TFLOPS`` is the peak the MFU share divides by.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import constants as C
from ..ops.bytenet import dilation_schedule
from ..ops.fused_attention import attention_matmul_flops
from ..ops.fused_bytenet import block_matmul_flops

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5, BF16 Tensor Core, dense
# (the datasheet's 1979 TFLOPS is with structured sparsity)
H100_SXM_BF16_DENSE_TFLOPS = 989.4


def kernels_active(device) -> bool:
    """True when the port's kernels run: on a CUDA device (a CPU tensor
    takes their plain versions). The counterpart of ``pallas_active``."""
    return torch.device(device).type == 'cuda'


def _segments(kind: str):
    if kind == 'pair':
        return (C.HEAVY_LEN, C.LIGHT_LEN)
    if kind == 'heavy':
        return (C.HEAVY_LEN,)
    raise ValueError(f'unknown kind: {kind!r}')


def denoiser_kernel_flops(cfg, B: int, *, kind: str, deterministic: bool = True,
                          backward: bool = False) -> float:
    """Matmul FLOPs inside the port's kernels for ONE evaluation of
    ``AntiTFNet`` (kind='pair') or ``NanoAntiTFNet`` (kind='heavy') on the
    card: K1 (and K3 with ``backward``) for the 2 * cs_layers attentions,
    K2 (and K4) for every ByteNet block of every tower. ``backward`` counts
    a forward and backward pass; ``deterministic`` is accepted for the JAX
    signature and does not change the port's routing."""
    head_dim = cfg.att_model // cfg.nhead
    att = 2 * cfg.cs_layers * attention_matmul_flops(
        B, cfg.max_len, cfg.nhead, head_dim, backward=backward)
    conv = 0.0
    for d, n_layers in ((cfg.d_model, cfg.n_encoder_layers),
                        (cfg.sum_d_model, cfg.dual_layers)):
        for L in _segments(kind):
            conv += n_layers * block_matmul_flops(B, L, d, d // 2, cfg.aa_kernel_size,
                                                  backward=backward)
    return att + conv


def _conv_taps(L: int, K: int, dilation: int) -> int:
    """Input rows a dilated 'same' conv of K taps reads over L outputs."""
    return sum(max(0, L - abs(t - (K - 1) // 2) * dilation) for t in range(K))


def _tower_flops(B, L, d, K, r, n_layers) -> float:
    h = d // 2
    return sum(2.0 * B * (L * 2 * d * h + _conv_taps(L, K, dil) * h * h)
               for dil in dilation_schedule(n_layers, r))


def denoiser_stage_flops(cfg, B: int, *, kind: str) -> Dict[str, float]:
    """Matmul FLOPs of one forward of ``B`` rows by stage: the aa towers,
    the dual (pair) or nano_conv (heavy) towers, the attention stack's
    projections and FFN (``self_att``) and its q k^T and p v products
    (``attention_core``), the embedders, the decoder. Conv taps that fall
    on the padding are not counted."""
    L, segs = cfg.max_len, _segments(kind)
    K, r = cfg.aa_kernel_size, cfg.r
    D, A, F = cfg.sum_d_model, cfg.att_model, cfg.dim_feedforward
    embed = (2.0 * B * L * cfg.r_embedding * cfg.r_model            # region
             + 2.0 * B * L * 2 * (cfg.n_pos_model * 2 * cfg.n_pos_model))   # pos MLP
    if kind == 'pair':   # side embedder: two rows a sequence
        embed += 2.0 * B * 2 * (cfg.s_embedding * cfg.s_model + cfg.s_model ** 2)
    return {
        'aa_towers': sum(_tower_flops(B, Ls, cfg.d_model, K, r, cfg.n_encoder_layers)
                         for Ls in segs),
        'dual_towers': sum(_tower_flops(B, Ls, D, K, r, cfg.dual_layers) for Ls in segs),
        'self_att': (2 * cfg.cs_layers * (2.0 * B * L * D * 3 * A + 2.0 * B * L * A * D)
                     + cfg.cs_layers * 2.0 * B * L * 2 * D * F),
        'attention_core': 2 * cfg.cs_layers * 4.0 * B * L * L * A,
        'embedders': embed,
        'decoder': 2.0 * B * L * D * cfg.n_tokens,
    }


def denoiser_model_flops(cfg, B: int, *, kind: str, backward: bool = False) -> float:
    """The whole model's matmul FLOPs for one forward of ``B`` rows, the sum
    of ``denoiser_stage_flops``; with ``backward``, a forward and backward
    pass: 3x the projections and conv taps, and the attention products as
    K1 and K3 count them (``attention_matmul_flops``)."""
    stages = denoiser_stage_flops(cfg, B, kind=kind)
    core = stages.pop('attention_core')
    if not backward:
        return sum(stages.values()) + core
    return 3.0 * sum(stages.values()) + 2 * cfg.cs_layers * attention_matmul_flops(
        B, cfg.max_len, cfg.nhead, cfg.att_model // cfg.nhead, backward=True)
