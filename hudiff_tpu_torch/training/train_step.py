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
``NanoAntiTFNet`` on [B, 152] ones. Each step is one device span ``step``
(``utils.tracing``): its host issue time and its device time.

Under a ``parallel.mesh.Mesh`` (``mesh=``) a step is handed its node's
whole batch and corrupts all of it, so that one node draws what one
process draws; each rank then runs the model on its DP rows
(``batch_slice``), the logits of every DP rank are gathered, and the loss
is taken over the gathered batch on every rank, as GSPMD takes it over the
global array. Each rank's gradients are its rows' share of that loss;
``TrainState`` sums them over the DP group, clips by the global norm
(split parameters summed over the TP group) and steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .. import constants as C
from ..ops import losses, masking
from ..parallel import mesh as M
from ..utils import tracing
from . import schedules


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and the count of optimizer steps; gradients
    are clipped to ``clip_norm`` (none when falsy) before each update. Under
    ``mesh`` they are first summed over the DP group, and the clip takes the
    global norm (``parallel.mesh.grad_norm``). ``grad_norm`` is the last
    update's norm before clipping (a tensor; None without clipping)."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    clip_norm: Optional[float] = None
    step: int = 0
    mesh: Optional[M.Mesh] = None
    grad_norm: Optional[torch.Tensor] = None

    def apply_gradients(self) -> None:
        if self.mesh is None:
            self.grad_norm = schedules.clip_gradients(self.model.parameters(), self.clip_norm)
        else:
            M.reduce_gradients(self.model.parameters(), self.mesh)
            self.grad_norm = schedules.clip_gradients(
                self.model.parameters(), self.clip_norm,
                norm=M.grad_norm(self.model.named_parameters(), self.mesh)
                if self.clip_norm else None)
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


def _local_rows(mesh, B, *ts):
    """This rank's DP rows of each [B, ...] tensor of the node's batch."""
    rows = M.batch_slice(mesh, B)
    return [t[rows] for t in ts]


def _gathered(mesh, *ts):
    """Each rank's rows of every tensor, over the DP group (the logits'
    gradient flows back to this rank's rows)."""
    return [M.gather_rows(t, mesh) for t in ts]


def make_pair_train_step(model, loss_type: str = 'merge', l_weight: float = 1.0,
                         mouse: bool = False, mesh: Optional[M.Mesh] = None) -> Callable:
    """Returns ``step(state, tokens, chain_type, seed, corrupted=None) ->
    metrics``: one optimizer step on clean grids ``tokens`` [B, 291] with
    ``chain_type`` [B, 2]; metrics are detached 0-d tensors on the device
    (``loss`` among them). ``model`` is ``state.model``, as in the JAX
    factory's signature. Under ``mesh`` the grids are the node's batch (see
    the module's docstring)."""
    rows = {}

    @tracing.span('step', device=True)
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
        src, tgt, mask, cdr_mask, region, chain_type = _local_rows(
            mesh, B, cor.src, tokens, cor.mask, cdr_mask, region, chain_type)
        logits, tgt, mask, cdr_mask = _gathered(
            mesh, state.model(src, region, chain_type), tgt, mask, cdr_mask)
        m = _pair_loss(logits, tgt, mask, cdr_mask, loss_type, l_weight)
        m['loss'].backward()
        state.apply_gradients()
        return {k: v.detach() for k, v in m.items()}

    return step


def make_heavy_train_step(model, mesh: Optional[M.Mesh] = None) -> Callable:
    """Nanobody pretrain step ``step(state, tokens, seed, corrupted=None) ->
    metrics`` on clean [B, 152] grids: the framework is corrupted, the CDRs
    are protected (reference nanobody_scripts/nanotrain.py:43-335). Under
    ``mesh``: as ``make_pair_train_step``."""
    rows = {}

    @tracing.span('step', device=True)
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
        src, tgt, mask, protected, region = _local_rows(
            mesh, B, cor.src, tokens, cor.mask, protected, region_row.expand(B, C.HEAVY_LEN))
        logits, tgt, mask, protected = _gathered(
            mesh, state.model(src, region), tgt, mask, protected)
        m = _heavy_loss(logits, tgt, mask, protected)
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
                   pair: bool = True, mesh: Optional[M.Mesh] = None) -> Callable:
    """Validation step ``step(tokens, chain_type, generator) -> metrics``:
    deterministic forward (``model.eval()``, no autograd), the same losses,
    no update; the model's mode is restored afterwards. ``pair=False`` is
    the heavy (nanobody) step: ``chain_type`` is ignored (pass None). Under
    ``mesh`` the metrics are those of the gathered global batch, the same
    on every rank."""
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
        src, tgt, mask, protected, region = _local_rows(
            mesh, B, cor.src, tokens, cor.mask, protected, region_row.expand(B, L))
        cond = () if not pair else tuple(_local_rows(mesh, B, chain_type))
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                logits, tgt, mask, protected = _gathered(
                    mesh, model(src, region, *cond), tgt, mask, protected)
                if not pair:
                    return _heavy_loss(logits, tgt, mask, protected)
                return _pair_loss(logits, tgt, mask, protected, loss_type, l_weight)
        finally:
            model.train(was_training)

    return step
