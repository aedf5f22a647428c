"""The benchmark's frozen arithmetic: peaks, kernel groups, device time by
kernel, and the operations and bytes of the model and of each kernel call.

Frozen copies, each from the file its header names, so that a change to the
program cannot move the yardstick. The counts are of the work the algorithm
needs for a call's inputs, whatever implements it:

- attention: q k^T and p v, 4 L^2 d a head; the backward, given the saved
  output and row log-sum-exp, recomputes the scores and takes dV, dP, dQ,
  dK: 10 L^2 d a head. The rotary embedding is elementwise work and not
  counted as products;
- ByteNet blocks: the two dense layers and only the conv taps that read
  the sequence (no tap on the zero padding); the backward is twice the
  forward's products (data and weight gradients);
- bytes: each input and weight read once, each output written once, at the
  width the call computes in (bf16 activations and weights, f32 LayerNorm
  parameters, biases and attention residuals).

A kernel's bound is the larger of its operations at the bf16 peak and its
bytes at the memory peak.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

# -- peaks: NVIDIA H100 SXM5 datasheet, dense (no structured sparsity) --------
BF16_FLOPS = 989.4e12          # bf16 tensor core
F32_FLOPS = 67.0e12            # float32 outside the tensor cores (TF32 off)
HBM_BYTES = 3.35e12            # HBM3

# -- kernel groups: frozen from chip_smoke.py::KERNEL_GROUPS ------------------
# The first group whose name fragment a kernel's name holds is its group.
KERNEL_GROUPS = (('K4', ('bytenet_bwd_',)), ('K3', ('rope_attention_bwd_',)),
                 ('K6', ('rope_attention_sep_bwd_',)),
                 ('K5', ('rope_attention_sep_fwd_kernel',)),
                 ('K1', ('rope_attention_qkv_kernel',)),
                 ('K7', ('plain_attention_kernel',)), ('K8', ('fused_layer_',)),
                 ('K2', ('bytenet_fwd_gemm_kernel',)),
                 ('cublas', ('gemm', 'cutlass', 'nvjet', 'xmma')))


def group_of(kernel_name: str) -> str:
    key = kernel_name.lower()
    return next((g for g, names in KERNEL_GROUPS if any(s in key for s in names)), 'other')


# -- device time a kernel adds: frozen from hudiff_tpu_torch/tools/__init__.py::added_ms
def added(intervals: Sequence[Tuple[float, float]]) -> List[float]:
    """The time each (start, end) interval adds to the time the device was
    busy, in the order given: from the later of its start and the end of
    every interval that started before it, to its end (0 where earlier ones
    cover it). A kernel launched to start under the previous one's tail is
    charged from that kernel's end. The values sum to the union's length."""
    out, last = [0.0] * len(intervals), None
    for i in sorted(range(len(intervals)), key=lambda k: intervals[k][0]):
        start, end = intervals[i]
        out[i] = max(0.0, end - (start if last is None else max(start, last)))
        last = end if last is None else max(last, end)
    return out


# -- model FLOPs: frozen from hudiff_tpu_torch/utils/flops.py -----------------
def dilations(n_layers: int, r: int) -> List[int]:
    """Dilations cycle through powers of two up to r (ops/bytenet.py)."""
    top = r.bit_length()
    return [2 ** (n % top) for n in range(n_layers)]


def conv_taps(L: int, K: int, dilation: int) -> int:
    """Input rows a dilated 'same' conv of K taps reads over L outputs."""
    return sum(max(0, L - abs(t - (K - 1) // 2) * dilation) for t in range(K))


def segments(kind: str, heavy_len: int, light_len: int) -> Tuple[int, ...]:
    return (heavy_len, light_len) if kind == 'pair' else (heavy_len,)


def _tower_flops(B, L, d, K, r, n_layers) -> float:
    h = d // 2
    return sum(2.0 * B * (L * 2 * d * h + conv_taps(L, K, dil) * h * h)
               for dil in dilations(n_layers, r))


def stage_flops(cfg: dict, kind: str, B: int, heavy_len: int, light_len: int
                ) -> Dict[str, float]:
    """Matmul FLOPs of one forward of ``B`` rows by stage."""
    L, segs = cfg['max_len'], segments(kind, heavy_len, light_len)
    K, r = cfg['aa_kernel_size'], cfg['r']
    D, A, Fd = cfg['sum_d_model'], cfg['att_model'], cfg['dim_feedforward']
    embed = (2.0 * B * L * cfg['r_embedding'] * cfg['r_model']
             + 2.0 * B * L * 2 * (cfg['n_pos_model'] * 2 * cfg['n_pos_model']))
    if kind == 'pair':
        embed += 2.0 * B * 2 * (cfg['s_embedding'] * cfg['s_model'] + cfg['s_model'] ** 2)
    return {
        'aa_towers': sum(_tower_flops(B, Ls, cfg['d_model'], K, r, cfg['n_encoder_layers'])
                         for Ls in segs),
        'dual_towers': sum(_tower_flops(B, Ls, D, K, r, cfg['dual_layers']) for Ls in segs),
        'self_att': (2 * cfg['cs_layers'] * (2.0 * B * L * D * 3 * A + 2.0 * B * L * A * D)
                     + cfg['cs_layers'] * 2.0 * B * L * 2 * D * Fd),
        'attention_core': 2 * cfg['cs_layers'] * 4.0 * B * L * L * A,
        'embedders': embed,
        'decoder': 2.0 * B * L * D * cfg['n_tokens'],
    }


def model_flops(cfg: dict, kind: str, B: int, heavy_len: int, light_len: int,
                backward: bool = False) -> float:
    """The model's matmul FLOPs for one forward of ``B`` rows; with
    ``backward``, a training step's: three times the forward (no
    recomputation counted)."""
    total = sum(stage_flops(cfg, kind, B, heavy_len, light_len).values())
    return 3.0 * total if backward else total


def abnativ_flops(hp: dict, B: int) -> float:
    """Matmul FLOPs of one AbNatiV forward of ``B`` one-hot rows: the
    strided conv embedding, 2 x ``num_mha_layers`` attention blocks (qkv,
    q k^T and p v, out, the MLP), the codebook's projections and cosine
    scores, the transposed conv (frozen from the scorer's architecture,
    hudiff_tpu_torch/models/abnativ.py)."""
    L = (hp['length_seq'] + 2 - hp['kernel']) // hp['stride'] + 1    # padding 1: 74
    d, ff = hp['d_embedding'], hp['d_ff']
    conv = 2.0 * B * L * hp['alphabet_size'] * hp['kernel'] * d
    block = 2.0 * B * L * (3 * d * d + 2 * L * d + d * d + 2 * d * ff)
    cb = hp['embedding_dim_code_book']
    vq = 2.0 * B * L * (2 * d * cb + cb * hp['num_embeddings'])
    return 2 * conv + 2 * hp['num_mha_layers'] * block + vq


# -- kernel calls --------------------------------------------------------------
def bytenet_calls(cfg: dict, kind: str, B: int, heavy_len: int, light_len: int
                  ) -> List[Tuple[int, int, int, int, int, int]]:
    """(B, L, D, H, K, dilation) of every ByteNet block call of one forward."""
    calls = []
    for d, n in ((cfg['d_model'], cfg['n_encoder_layers']), (cfg['sum_d_model'],
                                                              cfg['dual_layers'])):
        for L in segments(kind, heavy_len, light_len):
            calls += [(B, L, d, d // 2, cfg['aa_kernel_size'], dil)
                      for dil in dilations(n, cfg['r'])]
    return calls


def attention_calls(cfg: dict, B: int) -> List[Tuple[int, int, int, int]]:
    """(B, L, heads, head_dim) of every attention call of one forward."""
    hd = cfg['att_model'] // cfg['nhead']
    return [(B, cfg['max_len'], cfg['nhead'], hd)] * (2 * cfg['cs_layers'])


def bytenet_fwd(B, L, D, H, K, dil) -> Tuple[float, float]:
    """(operations, bytes) of one ByteNet block forward."""
    flops = 2.0 * B * (L * D * H + conv_taps(L, K, dil) * H * H + L * H * D)
    weights = 2.0 * (D * H + K * H * H + H * D) + 4.0 * (3 * D + 6 * H)
    return flops, 2.0 * 2 * B * L * D + weights


def bytenet_bwd(B, L, D, H, K, dil) -> Tuple[float, float]:
    """(operations, bytes) of one ByteNet block backward given x, the
    saved stage outputs p and q, and dy: it writes dx and the parameters'
    gradients."""
    flops, _ = bytenet_fwd(B, L, D, H, K, dil)
    weights = 2.0 * (D * H + K * H * H + H * D) + 4.0 * (3 * D + 6 * H)
    acts = 2.0 * B * L * (D + 2 * H + D + D)      # x, p, q, dy read; dx written
    return 2.0 * flops, acts + 2 * weights          # weights read, gradients written


def attention_fwd(B, L, heads, hd) -> Tuple[float, float]:
    A = heads * hd
    return 4.0 * B * heads * L * L * hd, 2.0 * B * L * (3 * A + A)


def attention_bwd(B, L, heads, hd) -> Tuple[float, float]:
    A = heads * hd
    return (10.0 * B * heads * L * L * hd,
            2.0 * B * L * (3 * A + A + 3 * A) + 4.0 * B * L * (A + heads))


def bound_s(ops_bytes: Iterable[Tuple[float, float]]) -> float:
    """The least time a list of (operations, bytes) calls could take."""
    return sum(max(f / BF16_FLOPS, b / HBM_BYTES) for f, b in ops_bytes)
