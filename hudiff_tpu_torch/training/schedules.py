"""Learning-rate schedules and the optimizer, with the reference's semantics.

Counterpart of hudiff_tpu/training/schedules.py. The host-side schedulers
(``warmup_poly_schedule``, ``ReduceOnPlateau``, ``CosineAnnealing``,
``make_host_scheduler``) are plain Python, copied with the same semantics:
- WarmupPolyLR: linear warmup from base lr to max_lr, then polynomial decay
  back toward base lr, floored at min_lr.
- ReduceLROnPlateau: decay lr by ``factor`` after ``patience`` validations
  without improvement.
- GradualWarmup: linear multiplier ramp over ``total_epoch`` validations,
  then hand off to plateau.

The optimizer is ``torch.optim.Adam`` / ``AdamW``. torch's Adam applies
``weight_decay`` as L2 into the gradient, which is the JAX package's
``_adam_l2`` (add_decayed_weights, then adam); ``AdamW`` decays the weights
decoupled, as ``optax.adamw``. Gradient clipping by global norm comes first
(``TrainState.apply_gradients`` calls ``clip_gradients`` before the step),
in the order of ``optax.chain(clip_by_global_norm, ...)``; a
tensor-parallel model's global norm sums its split parameters over the TP
group (``parallel.mesh.grad_norm``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Optional

import torch


def warmup_poly_schedule(base_lr: float, max_lr: float, min_lr: float,
                         warmup_iters: int, max_iters: int,
                         power: int = 2) -> Callable[[int], float]:
    def schedule(step) -> float:
        step = float(step)
        if step < warmup_iters:
            return base_lr + (max_lr - base_lr) * (step / max(warmup_iters, 1))
        frac = (step - warmup_iters) / max(max_iters - warmup_iters, 1)
        decay = (1.0 - min(max(frac, 0.0), 1.0)) ** power
        return max(max_lr * decay + (1.0 - decay) * base_lr, min_lr)

    return schedule


@dataclasses.dataclass
class ReduceOnPlateau:
    """Host-side plateau scheduler: call ``update(val_loss)`` after each
    validation; read ``lr`` for the next steps."""
    init_lr: float
    factor: float = 0.6
    patience: int = 10
    min_lr: float = 1e-6
    # GradualWarmup handoff (multiplier/total_epoch in the reference configs)
    warmup_multiplier: float = 1.0
    warmup_epochs: int = 0

    def __post_init__(self):
        self.lr = self.init_lr  # the warmup ramp is applied in update()
        self.best: Optional[float] = None
        self.bad = 0
        self.epoch = 0

    def update(self, val_loss: float) -> float:
        self.epoch += 1
        if self.epoch <= self.warmup_epochs:
            ramp = 1.0 + (self.warmup_multiplier - 1.0) * self.epoch / self.warmup_epochs
            self.lr = self.init_lr * ramp
            return self.lr
        if self.best is None or val_loss < self.best:
            self.best = val_loss
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad = 0
        return self.lr

    # scheduler state persists inside checkpoint metadata so resume continues
    # at the same LR/patience
    def state_dict(self) -> dict:
        return {'lr': self.lr, 'best': self.best, 'bad': self.bad,
                'epoch': self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.lr = float(state['lr'])
        self.best = None if state.get('best') is None else float(state['best'])
        self.bad = int(state.get('bad', 0))
        self.epoch = int(state.get('epoch', 0))


@dataclasses.dataclass
class CosineAnnealing:
    """Host-side cosine annealing: lr follows
    ``eta_min + (init - eta_min) * (1 + cos(pi * t / T_max)) / 2`` per
    validation step. Same ``update(val_loss) -> lr`` protocol as
    ReduceOnPlateau (the val loss is ignored)."""
    init_lr: float
    t_max: int = 100
    eta_min: float = 0.0

    def __post_init__(self):
        self.lr = self.init_lr
        self.epoch = 0

    def update(self, val_loss: float) -> float:
        self.epoch += 1
        t = min(self.epoch, self.t_max)
        self.lr = self.eta_min + (self.init_lr - self.eta_min) * \
            (1.0 + math.cos(math.pi * t / self.t_max)) / 2.0
        return self.lr

    def state_dict(self) -> dict:
        return {'lr': self.lr, 'epoch': self.epoch}

    def load_state_dict(self, state: dict) -> None:
        self.lr = float(state['lr'])
        self.epoch = int(state.get('epoch', 0))


def make_host_scheduler(sched_cfg, init_lr: float):
    """Factory over the host-side schedulers: 'plateau' (default) or
    'cosine'. Both expose ``update(val_loss) -> lr``."""
    kind = sched_cfg.get('type', 'plateau')
    get = sched_cfg.get
    if kind == 'cosine':
        return CosineAnnealing(init_lr=init_lr,
                               t_max=int(get('T_max', get('t_max', 100))),
                               eta_min=float(get('eta_min', 0.0)))
    if kind in ('plateau', 'warmup_plateau'):
        return ReduceOnPlateau(
            init_lr=init_lr,
            factor=get('factor', 0.6),
            patience=get('patience', 10),
            min_lr=get('min_lr', 1e-6),
            warmup_multiplier=get('multiplier', 1.0),
            warmup_epochs=get('total_epoch', 0))
    raise ValueError(f'unknown scheduler: {kind}')


def make_optimizer(opt_cfg, params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    """Adam (weight decay as L2 into the gradient; plain Adam when it is 0)
    or AdamW (decoupled decay) over ``params``."""
    kind = opt_cfg.get('type', 'Adam')
    kwargs = dict(lr=opt_cfg.lr, betas=(opt_cfg.get('beta1', 0.9), opt_cfg.get('beta2', 0.999)),
                  weight_decay=opt_cfg.get('weight_decay', 0.0) or 0.0)
    if kind == 'Adam':
        return torch.optim.Adam(params, **kwargs)
    if kind == 'AdamW':
        return torch.optim.AdamW(params, **kwargs)
    raise ValueError(f'unknown optimizer: {kind}')


def clip_gradients(params: Iterable[torch.nn.Parameter], clip_norm: Optional[float],
                   norm: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Scale the gradients to a global norm of at most ``clip_norm`` (none
    when it is falsy), as ``optax.clip_by_global_norm``; returns the norm
    before clipping. ``norm``, when given, is that norm, taken by the
    caller (a tensor-parallel model's spans ranks: ``parallel.mesh.
    grad_norm``); the scale is ``clip_grad_norm_``'s."""
    if not clip_norm:
        return None
    if norm is None:
        return torch.nn.utils.clip_grad_norm_(params, clip_norm)
    scale = torch.clamp(clip_norm / (norm + 1e-6), max=1.0)
    for p in params:
        if p.grad is not None:
            p.grad.mul_(scale.to(p.grad.dtype))
    return norm


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Set every parameter group's learning rate (the host-side scheduler's
    hand-off)."""
    for group in optimizer.param_groups:
        group['lr'] = float(lr)
    return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> Optional[float]:
    groups = optimizer.param_groups
    return float(groups[0]['lr']) if groups else None
