"""Reverse OA-ARDM sampling, one position per forward.

Counterpart of hudiff_tpu/sampling/sampler.py (``make_scan_sampler`` with
``positions_per_step = 1``, ``make_jit_sampler``'s bf16 cast-once, and
``build_order_rows``). The JAX package runs the loop as one ``lax.scan``;
here it is a Python loop of device work with no host synchronisation:

- each step runs one full forward, gathers every row's logits at its own
  position, draws a categorical over ``logits[..., :22]`` in f32 from an
  explicit ``torch.Generator`` on the model's device (Gumbel-max), and
  writes the token back;
- an order slot of -1 is a no-op, so rows with fewer masked positions share
  one ``[B, K]`` order matrix.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .. import constants as C

# Sampling vocabulary: every token but <msk> (the reference samples logits[:, i, :22]).
SAMPLE_TOP = C.N_TOKENS - 1


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row of ``logits`` [..., V] (f32), by Gumbel-max."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def make_scan_sampler(apply_fn: Callable[..., torch.Tensor]):
    """``sampler(tokens, order, generator, *cond) -> tokens`` around
    ``apply_fn(tokens, *cond) -> [B, L, V]`` logits; ``order`` is [B, K]
    int positions (-1 = no-op). ``tokens`` is not modified."""

    @torch.inference_mode()
    def sampler(tokens: torch.Tensor, order: torch.Tensor,
                generator: torch.Generator, *cond) -> torch.Tensor:
        tokens = tokens.clone()
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        for pos in order.t():                           # pos: [B]
            valid = pos >= 0
            safe = torch.where(valid, pos, torch.zeros_like(pos))
            logits = apply_fn(tokens, *cond)             # [B, L, V]
            sampled = categorical(logits[rows, safe, :SAMPLE_TOP], generator)
            cur = tokens[rows, safe]
            tokens[rows, safe] = torch.where(valid, sampled.to(tokens.dtype), cur)
        return tokens

    return sampler


def cast_params_once(model: torch.nn.Module) -> torch.nn.Module:
    """For a bf16-computing model, cast every >=2-D f32 parameter (Linear and
    conv weights, embedding tables, the decoder weight) to bf16 in place,
    once; LayerNorm parameters and biases stay f32. Halves the weight
    traffic of every step."""
    if getattr(model, 'dtype', torch.float32) == torch.bfloat16:
        for p in model.parameters():
            if p.dtype == torch.float32 and p.dim() >= 2:
                p.data = p.data.to(torch.bfloat16)
    return model


def make_model_sampler(model: torch.nn.Module):
    """``run(tokens, order, generator, *cond) -> tokens`` for a denoiser
    conditioned on ``cond``: ``(region, chain)`` for the paired one,
    ``(region,)`` for the nanobody one (the counterpart of
    ``make_jit_sampler`` with and without ``has_chain_type``). Puts the
    model in eval mode and applies ``cast_params_once`` to it."""
    return make_scan_sampler(cast_params_once(model.eval()))


def build_order_rows(position_sets: Sequence[Sequence[int]],
                     rng: Union[np.random.Generator, int, None] = None,
                     shuffle: bool = True,
                     pad_to: Optional[int] = None) -> np.ndarray:
    """[B, K] int32 orders where row b resamples ``position_sets[b]``
    (shuffled with ``rng``, a numpy Generator or seed; seed 0 if None),
    padded to ``pad_to`` with -1."""
    K = pad_to if pad_to is not None else max(
        (len(p) for p in position_sets), default=0)
    out = np.full((len(position_sets), K), -1, dtype=np.int32)
    rs = rng if isinstance(rng, np.random.Generator) else \
        np.random.default_rng(0 if rng is None else rng)
    for b, pos in enumerate(position_sets):
        pos = np.asarray(pos, dtype=np.int32)
        out[b, : len(pos)] = rs.permutation(pos) if shuffle else pos
    return out
