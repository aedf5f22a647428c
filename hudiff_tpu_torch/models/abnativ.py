"""AbNatiV VQ-VAE nativeness scorer, frozen, in PyTorch.

Counterpart of hudiff_tpu/models/abnativ.py. The scorer judges how human
(or camelid) an AHo-aligned one-hot chain looks; fine-tuning pushes the
infilling denoiser's output toward human scores through it:

  one-hot [B, 149, 21] -> Conv1d embed -> PE -> N MHA blocks
    -> cosine-similarity vector quantization (frozen codebook)
    -> PE -> N MHA blocks -> ConvTranspose1d -> softmax reconstruction

Parameters are named after the reference torch ``state_dict`` keys that
``hudiff_tpu/models/abnativ.py::convert_torch_abnativ`` reads
(``encoder.cnn_embedding.1.weight``, ``encoder.en_MHA_blocks.{i}.self_MHA.
in_proj_weight``, ``....MLperceptron.0/.3``, ``....layernorm1/2``,
``decoder.cnn_reconstruction.1.weight``, ``vqvae._codebook.embed``,
``vqvae.project_in/out``), so a reference-layout checkpoint loads with
``load_state_dict`` and ``flax_to_state_dict`` is that converter's inverse.

The attention is the Flax ``MultiHeadDotProductAttention`` the JAX package
uses (the query divided by sqrt(head_dim), no dropout), written with plain
torch ops; the scorer always computes in f32. ``straight_through`` passes
gradients through the codebook lookup (the Ab fine-tune keeps it on, the Nb
fine-tune off). Training machinery (k-means init, EMA updates) is absent,
as in the JAX package: every entry point keeps the scorer frozen.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import constants as C
from ..ops.norm import LN_EPS


# ---------------------------------------------------------------------------
# CNN geometry (copied from hudiff_tpu/models/abnativ.py:40-61, the
# reference's padding search loop included)
# ---------------------------------------------------------------------------

def _l_out_cnn1d(L_in: int, K: int, S: int, P: int, D: int = 1) -> float:
    return (L_in + 2 * P - D * (K - 1) - 1) / S + 1


def find_optimal_cnn1d_padding(L_in: int, K: int, S: int):
    if L_in < K:
        raise ValueError('kernel larger than input')
    P = 0
    L_out = _l_out_cnn1d(L_in, K, S, P)
    while not float(L_out).is_integer() and 2 * P <= S:
        L_out = _l_out_cnn1d(L_in, K, S, P)
        P += 1
    if 2 * P >= S:
        P -= 1
    return math.floor(L_out), P


def find_out_padding_cnn1d_transpose(L_obj: int, L_in: int, K: int, S: int,
                                     P: int) -> int:
    L_out = (L_in - 1) * S - 2 * P + (K - 1) + 1
    if L_obj < L_out:
        raise ValueError('transpose output larger than target')
    return L_obj - L_out


@dataclasses.dataclass(frozen=True)
class AbNatiVParams:
    """hparams dict carried inside the reference .ckpt files."""
    d_embedding: int = 128
    kernel: int = 4
    stride: int = 2
    num_heads: int = 4
    num_mha_layers: int = 4
    d_ff: int = 256
    length_seq: int = C.AHO_LEN
    alphabet_size: int = C.ABNATIV_ALPHABET_SIZE
    num_embeddings: int = 512     # codebook size
    embedding_dim_code_book: int = 32
    decay: float = 0.8
    commitment_cost: float = 1.0
    drop: float = 0.0

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> 'AbNatiVParams':
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})


def sinusoidal_table(d: int, max_len: int) -> np.ndarray:
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-np.log(10000.0) / d))
    pe = np.zeros((max_len, d), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe.astype(np.float32)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class SelfMHA(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` with torch
    ``nn.MultiheadAttention``'s parameter names: ``in_proj_weight`` [3d, d]
    (q, k, v rows; head h owns features h*hd:(h+1)*hd) and ``out_proj``."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, d = x.shape
        hd = d // self.heads
        q, k, v = (t.reshape(B, L, self.heads, hd).transpose(1, 2)
                   for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, -1))
        q = q / math.sqrt(hd)
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, L, d))


class MHABlock(nn.Module):
    """Post-norm MHA + MLP block (reference abnativ_model.py:45-77)."""

    def __init__(self, d: int, heads: int, d_ff: int, dropout: float = 0.0):
        super().__init__()
        self.self_MHA = SelfMHA(d, heads)
        self.drop = nn.Dropout(dropout)
        self.layernorm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.MLperceptron = nn.Sequential(nn.Linear(d, d_ff), nn.Dropout(dropout), nn.ReLU(),
                                          nn.Linear(d_ff, d))
        self.layernorm2 = nn.LayerNorm(d, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.layernorm1(x + self.drop(self.self_MHA(x)))
        return self.layernorm2(x + self.drop(self.MLperceptron(x)))


class _ChannelsFirst(nn.Module):
    """[B, L, C] <-> [B, C, L] (the reference's einops Rearrange layers)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2)


def _pe_buffer(hp: AbNatiVParams, l_red: int) -> torch.Tensor:
    return torch.from_numpy(sinusoidal_table(hp.d_embedding, l_red))


class AbNatiVEncoder(nn.Module):
    def __init__(self, hp: AbNatiVParams):
        super().__init__()
        l_red, padding = find_optimal_cnn1d_padding(hp.length_seq, hp.kernel, hp.stride)
        self.cnn_embedding = nn.Sequential(
            _ChannelsFirst(),
            nn.Conv1d(hp.alphabet_size, hp.d_embedding, hp.kernel, stride=hp.stride,
                      padding=padding),
            _ChannelsFirst())
        self.register_buffer('pe', _pe_buffer(hp, l_red), persistent=False)
        self.drop = nn.Dropout(hp.drop)
        self.en_MHA_blocks = nn.ModuleList(
            MHABlock(hp.d_embedding, hp.num_heads, hp.d_ff, hp.drop)
            for _ in range(hp.num_mha_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.cnn_embedding(x)
        h = self.drop(h + self.pe[: h.shape[1]])
        for blk in self.en_MHA_blocks:
            h = blk(h)
        return h


class AbNatiVDecoder(nn.Module):
    """MHA blocks, then a transposed conv with torch semantics: the VALID
    transpose cropped to ``[padding : padding + length_seq]`` (zero-extended
    if shorter), then a softmax over the alphabet."""

    def __init__(self, hp: AbNatiVParams):
        super().__init__()
        self.hp = hp
        l_red, self.padding = find_optimal_cnn1d_padding(hp.length_seq, hp.kernel,
                                                         hp.stride)
        find_out_padding_cnn1d_transpose(hp.length_seq, l_red, hp.kernel, hp.stride,
                                         self.padding)   # the reference's assert
        self.register_buffer('pe', _pe_buffer(hp, l_red), persistent=False)
        self.drop = nn.Dropout(hp.drop)
        self.de_MHA_blocks = nn.ModuleList(
            MHABlock(hp.d_embedding, hp.num_heads, hp.d_ff, hp.drop)
            for _ in range(hp.num_mha_layers))
        self.cnn_reconstruction = nn.Sequential(
            _ChannelsFirst(),
            nn.ConvTranspose1d(hp.d_embedding, hp.alphabet_size, hp.kernel, stride=hp.stride),
            _ChannelsFirst())

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        z = self.drop(q + self.pe[: q.shape[1]])
        for blk in self.de_MHA_blocks:
            z = blk(z)
        z = self.cnn_reconstruction(z)
        target = self.hp.length_seq
        z = z[:, self.padding: self.padding + target]
        if z.shape[1] < target:
            z = F.pad(z, (0, 0, 0, target - z.shape[1]))
        return torch.softmax(z, dim=-1)


class _Codebook(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.embed = nn.Parameter(torch.randn(n, dim))


class CosineVQ(nn.Module):
    """Frozen cosine-similarity codebook lookup (reference abnativ_vq.py:
    107-160, inference path; temperature 0, so argmax). Norms divide by
    ``norm + 1e-12``, as the JAX package does."""

    def __init__(self, hp: AbNatiVParams, straight_through: bool = False):
        super().__init__()
        self.hp, self.straight_through = hp, straight_through
        self.needs_proj = hp.embedding_dim_code_book != hp.d_embedding
        if self.needs_proj:
            self.project_in = nn.Linear(hp.d_embedding, hp.embedding_dim_code_book)
            self.project_out = nn.Linear(hp.embedding_dim_code_book, hp.d_embedding)
        self._codebook = _Codebook(hp.num_embeddings, hp.embedding_dim_code_book)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        xf = (self.project_in(x) if self.needs_proj else x).float()
        embed = self._codebook.embed
        x_n = xf / (torch.linalg.vector_norm(xf, dim=-1, keepdim=True) + 1e-12)
        e_n = embed / (torch.linalg.vector_norm(embed, dim=-1, keepdim=True) + 1e-12)
        ind = torch.argmax(torch.einsum('bnd,cd->bnc', x_n, e_n), dim=-1)
        quant = embed[ind]
        if self.straight_through:
            quant = xf + (quant - xf).detach()
        loss_pbe = torch.mean((quant - xf.detach()) ** 2, dim=(1, 2))
        if self.hp.commitment_cost > 0:
            loss_pbe = loss_pbe + self.hp.commitment_cost * torch.mean(
                (quant.detach() - xf) ** 2, dim=(1, 2))
        quant = quant.to(x.dtype)
        # code counts by a scatter-add: bincount would wait for the device
        flat = ind.reshape(-1)
        counts = torch.zeros(self.hp.num_embeddings, device=flat.device).index_add_(
            0, flat, torch.ones(flat.shape, device=flat.device))
        avg = counts / flat.numel()
        return {'quantize_projected_out': self.project_out(quant) if self.needs_proj else quant,
                'loss_vq_commit_pbe': loss_pbe,
                'encoding_indices': ind,
                'perplexity': torch.exp(-torch.sum(avg * torch.log(avg + 1e-10)))}


class AbNatiVModel(nn.Module):
    """The scorer: one-hot [B, 149, 21] -> dict of reconstruction errors
    (reference abnativ_model.py:190-213)."""

    def __init__(self, hp: AbNatiVParams, straight_through: bool = False):
        super().__init__()
        self.hp = hp
        self.encoder = AbNatiVEncoder(hp)
        self.vqvae = CosineVQ(hp, straight_through=straight_through)
        self.decoder = AbNatiVDecoder(hp)

    def forward(self, inputs: torch.Tensor) -> Dict[str, torch.Tensor]:
        vq = self.vqvae(self.encoder(inputs))
        x_recon = self.decoder(vq['quantize_projected_out'])
        err_pres_pposi = (x_recon - inputs) ** 2
        err_pposi = torch.mean(err_pres_pposi, dim=-1)
        err_pbe = torch.mean(err_pposi, dim=-1)
        return {'inputs': inputs, 'x_recon': x_recon,
                'recon_error_pres_pposi': err_pres_pposi,
                'recon_error_pposi': err_pposi,
                'recon_error_pbe': err_pbe,
                'loss_pbe': err_pbe + vq['loss_vq_commit_pbe'],
                **vq}


def frozen(model: AbNatiVModel) -> AbNatiVModel:
    """``model`` in eval mode with no parameter taking a gradient: gradients
    still reach its inputs."""
    return model.eval().requires_grad_(False)


# ---------------------------------------------------------------------------
# Nativeness scoring (copied from hudiff_tpu/models/abnativ.py:242-284)
# ---------------------------------------------------------------------------

def _rescale(raw: torch.Tensor, model_type: str) -> torch.Tensor:
    t_r = C.ABNATIV_BEST_THRESHOLDS.get(model_type)
    if t_r is None:
        return raw
    return (C.ABNATIV_RESCALE_TARGET - 1.0) / (t_r - 1.0) * (raw - 1.0) + 1.0


def nativeness_scores(output: Dict[str, torch.Tensor], portion_mask: torch.Tensor,
                      model_type: str, all_seq: bool = False) -> torch.Tensor:
    """Rescaled nativeness per sequence over the positions ``portion_mask``
    [B, 149] selects (ignored when ``all_seq``). A sequence with an empty
    selection scores 1.0 (reference abnativ_scoring.py:139-140).

    The empty row's mean is taken over a count of 1, not 0: the same 1.0
    (exp(0), which the rescale keeps), and a zero gradient for that row's
    errors where the JAX function's 0/0 gives NaN (ROADMAP.md, queue 3)."""
    err = output['recon_error_pposi']
    if all_seq:
        return _rescale(torch.exp(-err.sum(dim=-1) / err.shape[1]), model_type)
    m = portion_mask.to(err.dtype)
    norm = m.sum(dim=-1)
    empty = norm == 0
    rescaled = _rescale(torch.exp(-(err * m).sum(dim=-1) / torch.where(
        empty, torch.ones_like(norm), norm)), model_type)
    if C.ABNATIV_BEST_THRESHOLDS.get(model_type) is None:
        return rescaled
    return torch.where(empty, torch.ones_like(rescaled), rescaled)


def nativeness_scores_seq(output: Dict[str, torch.Tensor], model_type: str) -> torch.Tensor:
    """Whole-sequence variant normalized by the non-gap residue count
    (reference abnativ_scoring.py:144-183)."""
    err = output['recon_error_pposi']
    norm = (torch.argmax(output['inputs'], dim=-1) != C.ABNATIV_GAP_IDX).sum(dim=-1)
    return _rescale(torch.exp(-err.sum(dim=-1) / norm), model_type)


# ---------------------------------------------------------------------------
# Weights: the Flax tree of the JAX scorer <-> the reference state_dict
# ---------------------------------------------------------------------------

def flax_to_state_dict(tree: Mapping[str, Any], hp: AbNatiVParams) -> Dict[str, torch.Tensor]:
    """The reference-layout state_dict (f32, CPU) of a JAX ``AbNatiVModel``
    param tree (``{'params': ...}`` or the bare params): the inverse of
    ``convert_torch_abnativ`` (hudiff_tpu/models/abnativ.py:287-357)."""
    p = tree.get('params', tree)
    d, heads = hp.d_embedding, hp.num_heads
    sd: Dict[str, np.ndarray] = {}

    def dense(dst, node):
        sd[dst + '.weight'] = np.asarray(node['kernel']).T
        sd[dst + '.bias'] = np.asarray(node['bias'])

    def layernorm(dst, node):
        sd[dst + '.weight'] = np.asarray(node['scale'])
        sd[dst + '.bias'] = np.asarray(node['bias'])

    def mha_block(dst, node):
        mha = node['mha']
        sd[dst + '.self_MHA.in_proj_weight'] = np.concatenate(
            [np.asarray(mha[n]['kernel']).reshape(d, d).T for n in ('query', 'key', 'value')])
        sd[dst + '.self_MHA.in_proj_bias'] = np.concatenate(
            [np.asarray(mha[n]['bias']).reshape(d) for n in ('query', 'key', 'value')])
        sd[dst + '.self_MHA.out_proj.weight'] = np.asarray(mha['out']['kernel']).reshape(d, d).T
        sd[dst + '.self_MHA.out_proj.bias'] = np.asarray(mha['out']['bias'])
        dense(dst + '.MLperceptron.0', node['ff1'])
        dense(dst + '.MLperceptron.3', node['ff2'])
        layernorm(dst + '.layernorm1', node['norm1'])
        layernorm(dst + '.layernorm2', node['norm2'])

    enc, dec, vq = p['encoder'], p['decoder'], p['vqvae']
    sd['encoder.cnn_embedding.1.weight'] = np.asarray(enc['cnn']['kernel']).transpose(2, 1, 0)
    sd['encoder.cnn_embedding.1.bias'] = np.asarray(enc['cnn']['bias'])
    for i in range(hp.num_mha_layers):
        mha_block(f'encoder.en_MHA_blocks.{i}', enc[f'mha_{i}'])
        mha_block(f'decoder.de_MHA_blocks.{i}', dec[f'mha_{i}'])
    sd['decoder.cnn_reconstruction.1.weight'] = np.asarray(
        dec['cnn_t']['kernel']).transpose(2, 1, 0)
    sd['decoder.cnn_reconstruction.1.bias'] = np.asarray(dec['cnn_t']['bias'])
    sd['vqvae._codebook.embed'] = np.asarray(vq['codebook'])
    if 'project_in' in vq:
        dense('vqvae.project_in', vq['project_in'])
        dense('vqvae.project_out', vq['project_out'])
    return {k: torch.tensor(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}


def reference_state_dict(sd: Mapping[str, torch.Tensor], model: AbNatiVModel
                         ) -> Dict[str, torch.Tensor]:
    """The entries of a reference-layout ``state_dict`` that ``model``
    holds, as f32: a ``[1, n, d]`` codebook is squeezed to ``[n, d]``;
    entries the scorer does not use (the EMA codebook statistics) are left
    out. Raises ``KeyError`` naming what the file lacks."""
    want = model.state_dict()
    missing = sorted(k for k in want if k not in sd)
    if missing:
        raise KeyError(f'AbNatiV state_dict lacks {missing}')
    out = {k: torch.as_tensor(sd[k]).float() for k in want}
    embed = out['vqvae._codebook.embed']
    if embed.ndim == 3:
        out['vqvae._codebook.embed'] = embed[0]
    return out


def checkpoint_hparams(ckpt: Mapping[str, Any]) -> AbNatiVParams:
    """The hparams of a reference-layout checkpoint, unwrapped from
    ``hyper_parameters['hparams']`` where the released lightning files nest
    them (hudiff_tpu/models/abnativ.py:290-295)."""
    hp_dict = ckpt.get('hyper_parameters', ckpt.get('hparams', {}))
    if 'hparams' in hp_dict:
        hp_dict = hp_dict['hparams']
    return AbNatiVParams.from_dict(hp_dict)
