"""Pretrain steps: OA-ARDM corruption, forward, loss, backward, update.

Counterpart of hudiff_tpu/training/train_step.py:23-185. The JAX package
jits one device program per step; here the step runs eagerly, and on the
card its hot stages go through the port's kernels: K1/K3 for the
attentions and K2/K4 for the ByteNet blocks (the autograd Functions of
ops/fused_attention.py and ops/fused_bytenet.py).

A step leaves the model's mode alone: dropout is active when the caller
has put the model in ``train()`` (the JAX step always trains with
``deterministic=False``), and ``model.eval()`` gives a step without it.

Each step draws its corruption from a ``torch.Generator`` on the tokens'
device seeded from ``(seed, state.step)``, as ``fold_in(rng, state.step)``
keys the JAX step (train_step.py:79); torch's draws are not JAX's. A step
may instead be handed a fixed ``Corrupted``, which the parity tests use.
The pair step trains ``AntiTFNet`` on [B, 291] grids, the heavy step
``NanoAntiTFNet`` on [B, 152] ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import constants as C
from ..ops import losses, masking
from . import schedules


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of optimizer steps; gradients
    are clipped to ``clip_norm`` (none when falsy) before each update."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    clip_norm: Optional[float] = None
    step: int = 0

    def apply_gradients(self) -> None:
        schedules.clip_gradients(self.model.parameters(), self.clip_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def pair_region_batch(batch_size: int) -> np.ndarray:
    """[B, 291] region conditioning (constant per batch)."""
    row = np.concatenate([C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX])
    return np.broadcast_to(row, (batch_size, C.PAIR_LEN)).copy()


def heavy_region_batch(batch_size: int) -> np.ndarray:
    return np.broadcast_to(C.HEAVY_REGION_INDEX, (batch_size, C.HEAVY_LEN)).copy()


def generator(device, *keys: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from the integers ``keys``
    (e.g. ``(seed, step)``): the port's ``fold_in``."""
    seed = int(np.random.SeedSequence([int(k) for k in keys]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=torch.device(device)).manual_seed(seed & (2 ** 63 - 1))


def _pair_rows(device, mouse: bool = False):
    cdr = np.concatenate([C.HEAVY_CDR_KABAT_NO_VERNIER if mouse else C.HEAVY_CDR_INDEX,
                          C.LIGHT_CDR_KABAT_NO_VERNIER if mouse else C.LIGHT_CDR_INDEX])
    region = np.concatenate([C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX])
    return (torch.as_tensor(cdr, dtype=torch.long, device=device),
            torch.as_tensor(region, dtype=torch.long, device=device))


def _pair_loss(logits, tokens, mask, cdr_mask, loss_type: str, l_weight: float):
    if loss_type == 'split':
        m = losses.pair_oardm_split_loss(logits, tokens, mask, cdr_mask, l_weight=l_weight)
        m['loss'] = m['h_ce'] + m['l_ce'] + m['h_cdr_ce'] + m['l_cdr_ce']
    else:
        m = losses.pair_oardm_loss(logits, tokens, mask, cdr_mask)
        m['loss'] = m['ce'] + m['cdr_ce']
    return m


def make_pair_train_step(model, loss_type: str = 'merge', l_weight: float = 1.0,
                         mouse: bool = False) -> Callable:
    """Returns ``step(state, tokens, chain_type, seed, corrupted=None) ->
    metrics``: one optimizer step on clean grids ``tokens`` [B, 291] with
    ``chain_type`` [B, 2]; metrics are detached 0-d tensors on the device
    (``loss`` among them). ``model`` is ``state.model``, as in the JAX
    factory's signature."""
    rows = {}

    def step(state: TrainState, tokens: torch.Tensor, chain_type: torch.Tensor, seed: int,
             corrupted: Optional[masking.Corrupted] = None) -> Dict[str, torch.Tensor]:
        dev = tokens.device
        if dev not in rows:
            rows[dev] = _pair_rows(dev, mouse)
        cdr_row, region_row = rows[dev]
        B = tokens.shape[0]
        region = region_row.expand(B, C.PAIR_LEN)
        protected = masking.pair_protected_mask(tokens, cdr_row, protect_pads=mouse)
        cdr_mask = (cdr_row != 0).expand(B, C.PAIR_LEN)
        cor = corrupted if corrupted is not None else masking.corrupt(
            generator(dev, seed, state.step), tokens, protected)
        logits = state.model(cor.src, region, chain_type)
        m = _pair_loss(logits, tokens, cor.mask, cdr_mask, loss_type, l_weight)
        m['loss'].backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in m.items()}

    return step


def make_heavy_train_step(model) -> Callable:
    """Nanobody pretrain step ``step(state, tokens, seed, corrupted=None) ->
    metrics`` on clean [B, 152] grids: the framework is corrupted, the CDRs
    are protected (reference nanobody_scripts/nanotrain.py:43-335)."""
    rows = {}

    def step(state: TrainState, tokens: torch.Tensor, seed: int,
             corrupted: Optional[masking.Corrupted] = None) -> Dict[str, torch.Tensor]:
        dev = tokens.device
        if dev not in rows:
            rows[dev] = _heavy_rows(dev)
        cdr_row, region_row = rows[dev]
        B = tokens.shape[0]
        protected = (cdr_row != 0).expand(B, C.HEAVY_LEN)
        cor = corrupted if corrupted is not None else masking.corrupt(
            generator(dev, seed, state.step), tokens, protected)
        logits = state.model(cor.src, region_row.expand(B, C.HEAVY_LEN))
        m = _heavy_loss(logits, tokens, cor.mask, protected)
        m['loss'].backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in m.items()}

    return step


def _heavy_rows(device):
    return (torch.as_tensor(C.HEAVY_CDR_INDEX, dtype=torch.long, device=device),
            torch.as_tensor(C.HEAVY_REGION_INDEX, dtype=torch.long, device=device))


def _heavy_loss(logits, tokens, mask, cdr_mask):
    m = losses.heavy_oardm_loss(logits, tokens, mask, cdr_mask)
    m['loss'] = m['ce'] + m['cdr_ce']
    return m


def evaluate(step_metrics_fn: Callable[[Dict[str, Any], int], Dict[str, Any]],
             val_feed, n_batches: int) -> Dict[str, float]:
    """Average eval metrics over the FULL validation split (``n_batches``
    batches pulled from ``val_feed``): the reference iterates the entire
    val loader and averages; single-batch validation makes best-checkpoint
    selection noise-driven.

    ``step_metrics_fn(batch, j) -> metrics`` runs the eval step on one
    batch (j = batch index, for seeding)."""
    sums: Dict[str, float] = {}
    for j in range(n_batches):
        m = step_metrics_fn(next(val_feed), j)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
    return {k: v / n_batches for k, v in sums.items()}


def make_eval_step(model, loss_type: str = 'merge', l_weight: float = 1.0,
                   pair: bool = True) -> Callable:
    """Validation step ``step(tokens, chain_type, generator) -> metrics``:
    deterministic forward (``model.eval()``, no autograd), the same losses,
    no update; the model's mode is restored afterwards. ``pair=False`` is
    the heavy (nanobody) step: ``chain_type`` is ignored (pass None)."""
    rows = {}

    def step(tokens: torch.Tensor, chain_type: Optional[torch.Tensor],
             gen: torch.Generator) -> Dict[str, torch.Tensor]:
        dev = tokens.device
        if dev not in rows:
            rows[dev] = _pair_rows(dev) if pair else _heavy_rows(dev)
        cdr_row, region_row = rows[dev]
        B, L = tokens.shape
        protected = (cdr_row != 0).expand(B, L)
        cor = masking.corrupt(gen, tokens, protected)
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                if not pair:
                    return _heavy_loss(model(cor.src, region_row.expand(B, L)), tokens,
                                       cor.mask, protected)
                logits = model(cor.src, region_row.expand(B, L), chain_type)
                return _pair_loss(logits, tokens, cor.mask, protected, loss_type, l_weight)
        finally:
            model.train(was_training)

    return step
