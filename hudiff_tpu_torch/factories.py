"""Name-based factories, mirroring the reference dispatch API
(utils/train_utils.py:43-153): ``model_selected``, ``optimizer_selected``,
``scheduler_selected``, ``get_dataset``.

Counterpart of hudiff_tpu/factories.py over the port's modules:
``model_selected`` builds the port's denoisers (or the fine-tune configs),
``optimizer_selected`` a ``torch.optim`` optimizer over the given
parameters, ``scheduler_selected`` the host-side schedulers of
training/schedules.py, ``get_dataset`` the datasets of data/oas.py.
"""
from __future__ import annotations

from typing import Iterable

import torch

from .models.denoiser import AntiTFNet, DenoiserConfig, NanoAntiTFNet


def model_selected(config, dtype=torch.float32, device=None):
    """config.name -> model or fine-tune config (reference
    utils/train_utils.py:43-55)."""
    name = config.get('name')
    if name == 'trans_oadm':
        return AntiTFNet(DenoiserConfig.from_dict(dict(config.model)), dtype=dtype,
                         device=device)
    if name == 'nano':
        return NanoAntiTFNet(DenoiserConfig.from_dict(dict(config.model)), dtype=dtype,
                             device=device)
    if name == 'antibody_finetune':
        from .models.finetune import AbFinetuneConfig
        return AbFinetuneConfig(
            loss_type=config.model.loss_type,
            human_threshold=config.model.human_threshold,
            all_seq=config.model.all_seq,
            mutation=config.model.get('mutation', False))
    if name == 'infilling':
        from .models.finetune import NanoFinetuneConfig
        return NanoFinetuneConfig(
            loss_type=config.model.loss_type,
            vhh_nativeness=config.model.vhh_nativeness,
            temperature=config.model.temperature,
            human_threshold=config.model.human_threshold,
            human_all_seq=config.model.human_all_seq,
            vhh_all_seq=config.model.vhh_all_seq,
            equal_weight=config.model.equal_weight)
    raise ValueError(f'unknown model name: {name}')


def optimizer_selected(optimizer_cfg, params: Iterable[torch.nn.Parameter]
                       ) -> torch.optim.Optimizer:
    """-> Adam / AdamW over ``params`` (reference :58-72). Gradient clipping
    is the train state's (``TrainState.clip_norm``), not the optimizer's."""
    from .training.schedules import make_optimizer
    return make_optimizer(optimizer_cfg, params)


def scheduler_selected(scheduler_cfg, init_lr: float):
    """-> a host-side scheduler (reference :75-97): ``plateau`` ->
    ``ReduceOnPlateau``, ``warm_up`` -> ``warmup_poly_schedule``,
    ``cosine_annal`` -> ``CosineAnnealing`` (its ``update`` steps once a
    validation; the JAX package returns an optax schedule of the step)."""
    from .training import schedules
    kind = scheduler_cfg.get('type', 'plateau')
    if kind == 'plateau':
        return schedules.ReduceOnPlateau(
            init_lr=init_lr,
            factor=scheduler_cfg.get('factor', 0.6),
            patience=scheduler_cfg.get('patience', 10),
            min_lr=scheduler_cfg.get('min_lr', 1e-6))
    if kind == 'warm_up':
        return schedules.warmup_poly_schedule(
            base_lr=init_lr,
            max_lr=scheduler_cfg.max_lr,
            min_lr=scheduler_cfg.min_lr,
            warmup_iters=scheduler_cfg.warmup_steps,
            max_iters=scheduler_cfg.max_steps)
    if kind == 'cosine_annal':
        return schedules.CosineAnnealing(init_lr=init_lr, t_max=int(scheduler_cfg.T_max))
    raise ValueError(f'unknown scheduler: {kind}')


def get_dataset(root: str, name: str, version: str = 'tmp'):
    """-> dataset(s) with ``.splits`` (reference :105-153)."""
    from .data.oas import OasPairDataset, OasUnpairDataset
    if name == 'pair':
        return OasPairDataset(root, version=version)
    if name == 'mouse':
        return OasPairDataset(root, version=version, mouse=True)
    if name == 'unpair':
        return (OasUnpairDataset(root, chaintype='heavy'),
                OasUnpairDataset(root, chaintype='light'))
    if name == 'heavy':
        return OasUnpairDataset(root, chaintype='heavy')
    if name == 'vhh':
        return OasUnpairDataset(root, chaintype='vhh')
    raise NotImplementedError(f'Unknown dataset: {name}')
