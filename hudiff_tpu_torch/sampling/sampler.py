"""Reverse OA-ARDM sampling.

Counterpart of hudiff_tpu/sampling/sampler.py (``make_scan_sampler`` with
any ``positions_per_step``, ``make_jit_sampler``'s bf16 cast-once,
``build_order``, ``build_order_rows`` and ``sequential_reference_sampler``).
The JAX package runs the loop as one ``lax.scan``; here it is a Python loop
of device work with no host synchronisation:

- each step runs one full forward, gathers every row's logits at its own
  k positions, draws a categorical over ``logits[..., :22]`` in f32 from an
  explicit ``torch.Generator`` on the model's device (Gumbel-max), and
  writes the tokens back;
- an order slot of -1 is a no-op, so rows with fewer masked positions share
  one ``[B, K]`` order matrix.

``sequential_reference_sampler`` keeps the reference's cost structure
instead: one forward per position, the tokens read back to the host after
each draw.

A batch split over ranks (the humanize CLI's ``--shard``) samples the
same tokens: each rank runs its rows, and every step draws the whole
batch's noise from the shared seed and keeps those rows (``rows=``), as
JAX's sharded scan draws ``[B, ...]`` noise whatever the sharding.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import constants as C

# Sampling vocabulary: every token but <msk> (the reference samples logits[:, i, :22]).
SAMPLE_TOP = C.N_TOKENS - 1


def categorical(logits: torch.Tensor, generator: torch.Generator,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One draw per row of ``logits`` [..., V] (f32), by Gumbel-max.
    ``rows`` = (first, total): ``logits`` are rows first.. of a batch of
    ``total``; the noise of all ``total`` rows is drawn and theirs kept."""
    shape = logits.shape if rows is None else (rows[1], *logits.shape[1:])
    u = torch.rand(shape, generator=generator, device=logits.device, dtype=torch.float32)
    if rows is not None:
        u = u[rows[0]:rows[0] + logits.shape[0]]
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() + gumbel, dim=-1)


def make_scan_sampler(apply_fn: Callable[..., torch.Tensor], positions_per_step: int = 1):
    """``sampler(tokens, order, generator, *cond, rows=None) -> tokens``
    around ``apply_fn(tokens, *cond) -> [B, L, V]`` logits; ``order`` is
    [B, K] int positions (-1 = no-op). ``tokens`` is not modified. ``rows``
    = (first, total): these are rows first.. of a batch of ``total`` split
    over ranks, which draws the whole batch's noise (``categorical``).

    ``positions_per_step`` k > 1 pads the order with -1 to a multiple of k
    and runs ceil(K / k) forwards, each drawing its k positions
    independently given the current grid (the OA-ARDM acceleration; 1 is
    the reference's one position per forward)."""
    k = max(1, positions_per_step)

    @torch.inference_mode()
    def sampler(tokens: torch.Tensor, order: torch.Tensor,
                generator: torch.Generator, *cond,
                rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        B, L = tokens.shape
        row_ix = torch.arange(B, device=tokens.device)[:, None]
        n_steps = -(-order.shape[1] // k)
        order = torch.nn.functional.pad(order, (0, n_steps * k - order.shape[1]), value=-1)
        # column L takes the writes of -1 slots (JAX drops them), so a padded
        # slot that gathers position 0 never clobbers a real write there
        buf = torch.cat([tokens, tokens.new_zeros(B, 1)], dim=1)
        grid = buf[:, :L]
        for pos in order.reshape(B, n_steps, k).unbind(1):     # pos: [B, k]
            valid = pos >= 0
            logits = apply_fn(grid, *cond)                  # [B, L, V]
            sel = logits[row_ix, torch.where(valid, pos, 0), :SAMPLE_TOP]
            buf[row_ix, torch.where(valid, pos, L)] = categorical(sel, generator,
                                                                 rows).to(buf.dtype)
        return grid.clone()

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


def make_model_sampler(model: torch.nn.Module, positions_per_step: int = 1):
    """``run(tokens, order, generator, *cond) -> tokens`` for a denoiser
    conditioned on ``cond``: ``(region, chain)`` for the paired one,
    ``(region,)`` for the nanobody one (the counterpart of
    ``make_jit_sampler`` with and without ``has_chain_type``). Puts the
    model in eval mode and applies ``cast_params_once`` to it."""
    return make_scan_sampler(cast_params_once(model.eval()),
                             positions_per_step=positions_per_step)


def sequential_reference_sampler(model: torch.nn.Module):
    """Reference-style sampler: one forward per position of ``order[0]``,
    applied to every row, with the tokens read back to the host after each
    draw (the reference's cost structure, the denominator of speedups).
    -1 slots are skipped. Same ``run(tokens, order, generator, *cond)``
    convention as ``make_model_sampler``; returns the tokens on the device
    they came from."""
    model = cast_params_once(model.eval())

    @torch.inference_mode()
    def run(tokens: torch.Tensor, order: torch.Tensor, generator: torch.Generator,
            *cond) -> torch.Tensor:
        host = tokens.cpu().clone()
        for pos in order[0].tolist():
            if pos < 0:
                continue
            logits = model(host.to(tokens.device), *cond)
            host[:, pos] = categorical(logits[:, pos, :SAMPLE_TOP], generator).cpu()
        return host.to(tokens.device)

    return run


def build_order(mask_positions: Sequence[int], batch: int,
                rng: Union[np.random.Generator, int, None] = None, shuffle: bool = True,
                pad_to: Optional[int] = None) -> np.ndarray:
    """[B, K] orders that resample the same positions in every row (each
    row shuffled on its own); ``build_order_rows`` with one position set."""
    pos = np.asarray(mask_positions, dtype=np.int32)
    return build_order_rows([pos] * batch, rng=rng, shuffle=shuffle,
                            pad_to=len(pos) if pad_to is None else pad_to)


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
