"""The ('data', 'model') layout of a job's ranks, its sharding rules and the
collectives the parallel paths use.

Counterpart of hudiff_tpu/parallel/mesh.py. JAX lays a 2-D mesh over every
device of the job and lets GSPMD place each array by the rules below; here
one process drives one card, and the layout is explicit:

- ``init_distributed`` starts ``torch.distributed`` from the launcher's
  environment (``torchrun`` sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
  ``MASTER_PORT``): NCCL on ``cuda``, gloo on ``cpu``, unless the caller
  names the backend. A failed start raises; nothing falls back to one
  process.
- ``make_mesh(model_axis)`` splits the world into dp x tp: rank = dp_rank *
  tp + tp_rank, so each tensor-parallel (TP) group is ``tp`` contiguous
  ranks, and each data-parallel (DP) group the ranks of one ``tp_rank``.
- ``param_pspec`` is JAX's rule table over the port's ``state_dict`` names:
  the merged head-major qkv projection split by output row (at head
  boundaries), the attention out projection by input column, the FFN's
  ``ff1`` by output (its bias too: a split bias goes with its rows, where
  JAX leaves the ``Dense_0`` bias replicated) and ``ff2`` by input;
  everything else is replicated, the ``out`` and ``ff2`` biases among
  them, which are added once after the all-reduce.
- ``shard_state_dict`` cuts a full state dict (a tp = 1 model's, or one
  converted by ``from_flax_params``) to a rank's shard; ``gather_state_dict``
  and ``gather_optimizer_state`` rebuild the full ones, so that a checkpoint
  has the tp = 1 layout whatever tp wrote it.
- ``batch_slice`` is ``batch_sharding``'s counterpart: JAX's per-process
  rule, where each host (here a node) draws its own batch and the node's
  DP ranks split it; the ranks of one TP group keep the same rows.

The collectives reduce through ``all_reduce`` alone (a gather is a sum of
zero-padded blocks, which is exact), since gloo takes CUDA tensors there.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

# Parameter-name regexes -> partition spec of the torch tensor over the
# ('data', 'model') layout (nn.Linear weights are [out, in], the transpose
# of Flax's [in, out] kernels, so JAX's P(None, 'model') is ('model', None)).
_TP_RULES = (
    (re.compile(r'(^|\.)attn(_c)?\.qkv\.weight$'), ('model', None)),
    (re.compile(r'(^|\.)attn(_c)?\.qkv\.bias$'), ('model',)),
    (re.compile(r'(^|\.)attn(_c)?\.out\.weight$'), (None, 'model')),
    (re.compile(r'(^|\.)blocks\.\d+\.ff1\.weight$'), ('model', None)),
    (re.compile(r'(^|\.)blocks\.\d+\.ff1\.bias$'), ('model',)),
    (re.compile(r'(^|\.)blocks\.\d+\.ff2\.weight$'), (None, 'model')),
)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a dp x tp layout: its coordinates, the node
    (``nodes`` of them, ``dp // nodes`` DP ranks each) and the process
    groups of its TP and DP groups (None where the group is one rank)."""
    dp: int = 1
    tp: int = 1
    dp_rank: int = 0
    tp_rank: int = 0
    nodes: int = 1
    node_rank: int = 0
    tp_group: Any = None
    dp_group: Any = None

    @property
    def world(self) -> int:
        return self.dp * self.tp

    @property
    def rank(self) -> int:
        return self.dp_rank * self.tp + self.tp_rank


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device='cuda') -> torch.device:
    """This rank's device: ``cuda:<local rank>`` (modulo the cards present,
    so that ranks may share one) for ``cuda``, else ``device`` itself."""
    dev = torch.device(device)
    if dev.type != 'cuda' or dev.index is not None:
        return dev
    from ..utils.device import resolve_device
    resolve_device(dev)
    local = int(os.environ.get('LOCAL_RANK', dist.get_rank() if dist.is_initialized() else 0))
    return torch.device('cuda', local % torch.cuda.device_count())


def init_distributed(backend: Optional[str] = None, device='cuda',
                     init_method: Optional[str] = None, rank: Optional[int] = None,
                     world: Optional[int] = None) -> torch.device:
    """Start ``torch.distributed`` and return this rank's device.

    ``rank`` and ``world`` default to the launcher's ``RANK`` and
    ``WORLD_SIZE``, ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``); a ``file://`` rendezvous needs neither address. The
    backend is NCCL for ``cuda`` and gloo for ``cpu`` unless named. NCCL
    refuses two ranks on one card, so more local ranks than cards raise
    here with a message that says so. Already started: returns the device."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    env = os.environ
    if rank is None or world is None:
        missing = [k for k in ('RANK', 'WORLD_SIZE') if k not in env]
        if init_method is None:
            missing += [k for k in ('MASTER_ADDR', 'MASTER_PORT') if k not in env]
        if missing:
            raise RuntimeError(f'init_distributed: no launcher environment ({", ".join(missing)} '
                               'unset); launch under torchrun or pass rank, world and '
                               'init_method')
    rank = int(env['RANK']) if rank is None else rank
    world = int(env['WORLD_SIZE']) if world is None else world
    backend = backend or ('nccl' if dev.type == 'cuda' else 'gloo')
    if backend == 'nccl':
        local_world = int(env.get('LOCAL_WORLD_SIZE', world))
        if local_world > torch.cuda.device_count():
            raise RuntimeError(f'init_distributed: {local_world} ranks on a node of '
                               f'{torch.cuda.device_count()} card(s); NCCL refuses two ranks '
                               "on one card (pass backend='gloo' to share a card)")
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or 'env://', rank=rank,
                            world_size=world)
    return dev


def make_mesh(model_axis: int = 1) -> Mesh:
    """The dp x tp layout of the started world (one rank without a process
    group). The node is ``GROUP_RANK`` of ``WORLD_SIZE / LOCAL_WORLD_SIZE``
    (torchrun's), one node when unset; a TP group must not span nodes.
    Every rank must call this at the same point: it creates the groups."""
    n = world_size()
    assert n % model_axis == 0, f'{n} ranks not divisible by model={model_axis}'
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get('LOCAL_WORLD_SIZE', n))
    assert n % local == 0 and local % model_axis == 0, \
        f'{local} ranks a node do not hold whole TP groups of {model_axis}'
    dp, tp = n // model_axis, model_axis
    tp_group = dp_group = None
    if n > 1:
        for d in range(dp):   # every rank creates every group, in one order
            g = dist.new_group([d * tp + t for t in range(tp)])
            tp_group = g if d == rank // tp else tp_group
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(dp)])
            dp_group = g if t == rank % tp else dp_group
    return Mesh(dp=dp, tp=tp, dp_rank=rank // tp, tp_rank=rank % tp, nodes=n // local,
                node_rank=int(os.environ.get('GROUP_RANK', rank // local)),
                tp_group=tp_group if tp > 1 else None, dp_group=dp_group if dp > 1 else None)


# -- sharding rules ------------------------------------------------------------

def param_pspec(name: str) -> Tuple:
    """The partition spec of a ``state_dict`` entry: ('model', None) split by
    rows, (None, 'model') by columns, ('model',) a split bias, () replicated."""
    for rx, spec in _TP_RULES:
        if rx.search(name):
            return spec
    return ()


def shard_dim(name: str) -> Optional[int]:
    """The dimension of ``name`` split over the TP group, or None."""
    spec = param_pspec(name)
    return spec.index('model') if 'model' in spec else None


def _block(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    if t.shape[dim] % mesh.tp:
        raise ValueError(f'a dimension of {t.shape[dim]} does not split over tp={mesh.tp}')
    n = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.tp_rank * n, n).contiguous()


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The rank's shard of a full state dict (the entries ``param_pspec``
    splits cut to the rank's block, the rest as they are)."""
    if mesh.tp == 1:
        return dict(sd)
    return {k: v if shard_dim(k) is None else _block(v, shard_dim(k), mesh)
            for k, v in sd.items()}


def _gather_dim(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * mesh.tp
    full = t.new_zeros(shape)
    full.narrow(dim, mesh.tp_rank * n, n).copy_(t)
    return all_reduce_(full, mesh.tp_group)


def gather_state_dict(sd: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """The full state dict from every rank's shard (a collective over the
    TP group: every rank calls it)."""
    if mesh.tp == 1:
        return dict(sd)
    return {k: v if shard_dim(k) is None else _gather_dim(v.detach(), shard_dim(k), mesh)
            for k, v in sd.items()}


def _optimizer_state(opt_sd, names, move):
    """``opt_sd`` with each parameter's state tensors of the parameter's
    rank passed through ``move(tensor, dim)``; the optimizer indexes its
    parameters in ``model.parameters()`` order, which ``names`` follows."""
    state = {}
    for idx, entry in opt_sd['state'].items():
        dim = shard_dim(names[idx])
        state[idx] = {k: move(v, dim) if dim is not None and torch.is_tensor(v) and v.dim() > dim
                      else v for k, v in entry.items()}
    return {**opt_sd, 'state': state}


def gather_optimizer_state(opt_sd: dict, model: torch.nn.Module, mesh: Mesh) -> dict:
    """The optimizer state dict of the full model from the rank's (a
    collective over the TP group)."""
    if mesh.tp == 1:
        return opt_sd
    names = [n for n, _ in model.named_parameters()]
    return _optimizer_state(opt_sd, names, lambda v, d: _gather_dim(v, d, mesh))


def shard_optimizer_state(opt_sd: dict, model: torch.nn.Module, mesh: Mesh) -> dict:
    """The rank's shard of a full model's optimizer state dict."""
    if mesh.tp == 1:
        return opt_sd
    names = [n for n, _ in model.named_parameters()]
    return _optimizer_state(opt_sd, names, lambda v, d: _block(v, d, mesh))


def batch_slice(mesh: Optional[Mesh], batch: int) -> slice:
    """The rows of a node's batch of ``batch`` rows this rank keeps: the
    node's DP ranks split it in order; the ranks of a TP group share rows."""
    if mesh is None or mesh.dp == 1:
        return slice(0, batch)
    per_node = mesh.dp // mesh.nodes
    if batch % per_node:
        raise ValueError(f'a batch of {batch} rows does not split over {per_node} '
                         'data-parallel ranks')
    n = batch // per_node
    i = mesh.dp_rank % per_node
    return slice(i * n, (i + 1) * n)


# -- collectives ---------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (nothing for a one-rank group)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def _gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    full = torch.zeros((mesh.dp * t.shape[0], *t.shape[1:]),
                       dtype=torch.uint8 if t.dtype == torch.bool else t.dtype,
                       device=t.device)
    full[mesh.dp_rank * t.shape[0]:(mesh.dp_rank + 1) * t.shape[0]] = t.detach()
    all_reduce_(full, mesh.dp_group)
    return full.bool() if t.dtype == torch.bool else full


class _GatherRows(torch.autograd.Function):
    """``_gather_rows`` whose backward keeps this rank's rows of the
    gradient: the caller computes the same function of the gathered tensor
    on every DP rank, so each rank's slice is its rows' whole gradient."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.rows = slice(mesh.dp_rank * t.shape[0], (mesh.dp_rank + 1) * t.shape[0])
        return _gather_rows(t, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rows], None


def gather_rows(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """``t`` [b, ...] of every DP rank, concatenated in DP order: [dp * b,
    ...] on every rank (bool and integer tensors too; exact). Under
    autograd the gradient returns to each rank's rows (``_GatherRows``)."""
    if mesh is None or mesh.dp == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherRows.apply(t, mesh)
    return _gather_rows(t, mesh)


def reduce_gradients(params: Iterable[torch.nn.Parameter], mesh: Optional[Mesh]) -> None:
    """Sum the gradients over the DP group, in one flat buffer: each rank's
    gradient is its rows' share of the loss over the gathered batch."""
    if mesh is None or mesh.dp == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh.dp_group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def grad_norm(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
              mesh: Optional[Mesh]) -> torch.Tensor:
    """The global L2 norm of the gradients, as ``optax.clip_by_global_norm``
    sees them under GSPMD: the squared norms of split parameters summed over
    the TP group, the replicated ones counted once."""
    split, rep = [], []
    for name, p in named_params:
        if p.grad is not None:
            (split if shard_dim(name) is not None else rep).append(
                torch.linalg.vector_norm(p.grad.float()) ** 2)
    dev = (split or rep)[0].device if (split or rep) else 'cpu'
    s = torch.stack(split).sum() if split else torch.zeros((), device=dev)
    r = torch.stack(rep).sum() if rep else torch.zeros((), device=dev)
    if mesh is not None and mesh.tp > 1:
        s = all_reduce_(s.clone(), mesh.tp_group)
    return torch.sqrt(s + r)


def broadcast_object(obj, mesh: Optional[Mesh]):
    """Rank 0's ``obj`` on every rank."""
    if mesh is None or mesh.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
