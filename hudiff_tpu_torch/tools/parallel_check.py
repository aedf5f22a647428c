"""Hold the parallel paths against one process: a tensor- or data-parallel
pretrain step, ``pretrain.run`` on several ranks, and a sharded sampling
round.

    python -m hudiff_tpu_torch.tools.parallel_check step --world 2 --tp 2 \\
        --out DIR [--device cpu] [--test-size] [--fp32] [--batch 128]
    python -m hudiff_tpu_torch.tools.parallel_check sample --world 2 --out DIR \\
        --pairs PAIRS.json [--ckpt CKPT.pt] [--batch 16]

Without ``--rank`` a command launches ``--world`` processes of itself,
each with a rank, over a ``file://`` rendezvous in ``--out`` (gloo: on the
cards present, sharing one if need be, or with ``--device cpu`` on the
CPU), waits for them under ``--timeout`` and stops them all if one fails
or the time runs out. Each rank writes ``rank<r>.pt`` in ``--out``;
``launch`` and the ``*_result`` functions are the library form, with which
a caller computes the one-process result in its own process and compares
(``compare_steps``). Like every entry point of the port, they run on the
card unless the caller passes ``device='cpu'``.

- ``step``: one pretrain step of the model ``pretrain.run`` builds from
  ``--seed`` (``build_model``: every rank draws the tp = 1 weights and
  keeps its shard), on the node batch of ``--batch`` rows from ``--seed``
  (the step's own corruption), Adam, clip ``--clip-norm``, dropout
  ``--dropout`` (0: the positional MLP's fixed p = 0.5 off too, so that
  DP ranks, whose dropout streams differ, can match one process). Rank 0's
  file holds the loss, the global gradient norm, the clipped gradients and
  the updated parameters gathered to the tp = 1 layout; every rank's the
  replicated activations (the towers' and embedders' outputs) and its
  launch counters. ``--profile`` adds a profiled warm step (bf16 with
  ``--fp32`` off): its kernels by group beside the counters. In one
  process, ``step_result(order=(dp, tp))`` is the step's witness: world 1
  with the sums the ranks split split as they split them
  (``in_parallel_order``), which tells a parallel step's fault from
  summation order.
- ``pretrain``: ``pretrain.run`` at ``--tp`` on the synthetic data of the
  run's config (``--config``), returning the run directory.
- ``sample``: one ``PairHumanizer.humanize_many`` round over ``--pairs``
  with ``mesh=`` the world; rank 0 writes the grids.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as C
from ..models.denoiser import AntiTFNet, DenoiserConfig, nano_config
from ..models.embedders import norm
from ..ops.fused_attention import rope_attention_qkv
from ..parallel import mesh as M
from ..training import pretrain as PT
from ..training import schedules, train_step as T
from ..utils.config import Namespace
from ..utils.device import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def launch(argv: List[str], world: int, out_dir: str, timeout: float) -> List[str]:
    """Run ``world`` processes of this tool's ``argv`` (a command and its
    flags), ranks 0.. over a ``file://`` rendezvous in ``out_dir``; returns
    their outputs. Raises, after stopping every process, when one exits
    nonzero or ``timeout`` seconds pass."""
    os.makedirs(out_dir, exist_ok=True)
    rdzv = os.path.join(os.path.abspath(out_dir), 'rendezvous')
    if os.path.exists(rdzv):
        os.remove(rdzv)
    base = dict(os.environ)
    base['PYTHONPATH'] = REPO + os.pathsep + base.get('PYTHONPATH', '')
    procs = []
    for r in range(world):
        child = dict(base, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world))
        procs.append(subprocess.Popen(
            [sys.executable, '-m', 'hudiff_tpu_torch.tools.parallel_check', *argv,
             '--rank', str(r), '--world', str(world), '--init-method', f'file://{rdzv}'],
            cwd=REPO, env=child, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise TimeoutError(f'parallel_check {argv[0]}: ranks still running after '
                           f'{timeout} s') from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise RuntimeError(f'parallel_check {argv[0]}: rank {r} exited {p.returncode}:\n'
                               + out[-6000:])
    return outs


def step_config(kind: str, test_size: bool, dropout: float) -> DenoiserConfig:
    cfg = DenoiserConfig() if kind == 'pair' else nano_config()
    return dataclasses.replace(cfg.test_size() if test_size else cfg, dropout=dropout)


def _counters() -> Dict[str, int]:
    from ..ops import fused_attention as FA
    from ..ops import fused_bytenet as FB
    return {'K1': FA.launches, 'K2': FB.launches, 'K3': FA.bwd_launches,
            'K4': FB.bwd_launches}


def _reset_counters() -> None:
    from ..ops import fused_attention as FA
    from ..ops import fused_bytenet as FB
    FA.launches = FB.launches = FA.bwd_launches = FB.bwd_launches = 0


def step_batch(kind: str, B: int, seed: int, device):
    """(tokens, chain or None): a node batch of B rows from ``seed``."""
    rs = np.random.RandomState(seed)
    L = C.PAIR_LEN if kind == 'pair' else C.HEAVY_LEN
    tokens = torch.as_tensor(rs.randint(0, C.N_AA, (B, L)), device=device)
    if kind != 'pair':
        return tokens, None
    chain = np.stack([np.zeros(B, np.int64), rs.randint(1, 3, B)], axis=1)
    return tokens, torch.as_tensor(chain, device=device)


def _row_blocks(forward, parts: int, *args):
    """``forward`` on ``parts`` consecutive row blocks, one after another,
    the outputs concatenated: a DP group's forwards in one process
    (autograd sums a parameter's blocks as the DP all-reduce sums the
    ranks')."""
    n = args[0].shape[0] // parts
    return torch.cat([forward(*(a[i * n:(i + 1) * n] for a in args)) for i in range(parts)])


def _columns(x, layer, dtype, tp: int):
    """A column-split projection's tp blocks of output columns. The view
    gives the blocks' input gradients one node, where they are summed
    before the rest of ``x``'s, as ``copy_to_tp`` sums them."""
    x = x.view_as(x).to(dtype)
    n = layer.weight.shape[0] // tp
    return [F.linear(x, layer.weight[r * n:(r + 1) * n].to(dtype),
                     layer.bias[r * n:(r + 1) * n].to(dtype)) for r in range(tp)]


def _rows(parts, layer, dtype, tp: int):
    """A row-split projection of the tp blocks ``parts``: each block's
    partial product with its columns of the weight (contiguous, as a rank
    holds them), the partials summed in f32 in rank order, the bias added
    once, as ``row_dense``."""
    k = layer.weight.shape[1] // tp
    total = None
    for r, x in enumerate(parts):
        y = F.linear(x.to(dtype), layer.weight[:, r * k:(r + 1) * k].contiguous().to(dtype))
        total = y.float() if total is None else total + y.float()
    return total.to(dtype) + layer.bias.to(dtype)


def _tp_attention(attn, tp: int, x):
    L = x.shape[1]
    parts = [rope_attention_qkv(qkv, attn.cos[:L], attn.sin[:L], attn.scale, attn.nhead // tp)
             for qkv in _columns(x, attn.qkv, attn.dtype, tp)]
    return _rows(parts, attn.out, attn.dtype, tp)


def _tp_block(block, tp: int, x):
    at = x + block.attn(x)
    at = at + block.attn_c(norm(at, block.norm1))
    h = [F.relu(c) for c in _columns(norm(at, block.norm2), block.ff1, block.dtype, tp)]
    return _rows(h, block.ff2, block.dtype, tp) + x


def in_parallel_order(model: torch.nn.Module, dp: int, tp: int) -> torch.nn.Module:
    """Make ``model`` (full weights, no mesh) the one-process witness of a
    dp x tp step: it computes what the ranks compute, at their shapes and
    in their order, without collectives: the rows in dp blocks
    (``_row_blocks``), each attention in tp head groups and each FFN in tp
    unit blocks, the row-split projections' partials summed in rank order.
    With ``InOrderState``'s clip the rest is world 1's step."""
    if tp > 1:
        for block in model.self_att.blocks:
            for attn in (block.attn, block.attn_c):
                attn.forward = functools.partial(_tp_attention, attn, tp)
            block.forward = functools.partial(_tp_block, block, tp)
    if dp > 1:
        model.forward = functools.partial(_row_blocks, model.forward, dp)
    return model


def norm_in_parallel_order(named_params, tp: int) -> torch.Tensor:
    """The global gradient norm of full-width gradients as
    ``parallel.mesh.grad_norm`` takes it on a mesh of ``tp``: each TP
    rank's squares of its blocks of the split parameters, the ranks' sums
    added in rank order, then the replicated parameters' squares."""
    named = [(n, p.grad) for n, p in named_params if p.grad is not None]
    ranks = [torch.stack([torch.linalg.vector_norm(
        M.shard_state_dict({n: g}, M.Mesh(tp=tp, tp_rank=r))[n].float()) ** 2
        for n, g in named if M.shard_dim(n) is not None]).sum() for r in range(tp)]
    s = ranks[0]
    for x in ranks[1:]:
        s = s + x
    rep = [torch.linalg.vector_norm(g.float()) ** 2 for n, g in named if M.shard_dim(n) is None]
    return torch.sqrt(s + torch.stack(rep).sum())


@dataclasses.dataclass
class InOrderState(T.TrainState):
    """``TrainState`` of the witness of a dp x tp step (``order``; see
    ``in_parallel_order``): the clip takes ``norm_in_parallel_order``, as
    the ranks' clip takes the norm."""
    order: tuple = (1, 1)

    def apply_gradients(self) -> None:
        if self.order == (1, 1) or not self.clip_norm:
            return super().apply_gradients()
        self.grad_norm = schedules.clip_gradients(
            self.model.parameters(), self.clip_norm,
            norm=norm_in_parallel_order(self.model.named_parameters(), self.order[1]))
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def build_step(kind: str, cfg: DenoiserConfig, dtype, device, seed: int,
               mesh: Optional[M.Mesh], clip_norm: Optional[float], order=(1, 1)):
    """(model in train mode, TrainState, step(tokens, chain, seed)): the
    model ``pretrain.run`` builds from ``seed`` (``build_model``: this
    rank's shard under a mesh of tp > 1), Adam at lr 1e-4, dropout's
    generator seeded by DP rank as ``run`` seeds it. ``order`` (dp, tp),
    without a mesh: the step of ``in_parallel_order``."""
    torch.manual_seed(seed)
    model = PT.build_model(kind, cfg, dtype, device, mesh)
    if not cfg.dropout:   # dropout 0 everywhere: the positional MLP's fixed 0.5 too
        model.pos_encoder.mlp.dropout = 0.0
    PT.seed_dropout(seed, mesh)
    opt = schedules.make_optimizer(Namespace({'type': 'Adam', 'lr': 1e-4}), model.parameters())
    state = InOrderState(in_parallel_order(model, *order), opt, clip_norm=clip_norm, mesh=mesh,
                         order=tuple(order))
    if kind == 'pair':
        fn = T.make_pair_train_step(model, mesh=mesh)
        return model.train(), state, lambda tok, chain, s: fn(state, tok, chain, s)
    fn = T.make_heavy_train_step(model, mesh=mesh)
    return model.train(), state, lambda tok, chain, s: fn(state, tok, s)


def step_result(kind: str = 'pair', test_size: bool = True, dtype=torch.float32,
                batch: int = 8, seed: int = 7, dropout: float = 0.0,
                clip_norm: Optional[float] = None, device='cuda',
                mesh: Optional[M.Mesh] = None, order=(1, 1)) -> dict:
    """One step (see the module's docstring): ``loss``, ``grad_norm`` (None
    without clipping), ``grads`` (clipped) and ``params`` (updated), both
    gathered to the tp = 1 layout (a collective under a mesh), the
    ``activations`` of the replicated stages and ``launches``. ``order``
    (dp, tp), in one process: the witness of a dp x tp step
    (``in_parallel_order``)."""
    device = resolve_device(device)
    cfg = step_config(kind, test_size, dropout)
    model, state, step = build_step(kind, cfg, dtype, device, seed, mesh, clip_norm, order)
    grads, acts = {}, {}
    state.optimizer.register_step_pre_hook(lambda opt, a, k: grads.update(
        (n, p.grad.detach().clone()) for n, p in model.named_parameters()))
    towers = model.dual_conv if kind == 'pair' else model.nano_conv
    for name, mod in (('towers', towers), ('pos', model.pos_encoder), ('self_att',
                                                                       model.self_att)):
        mod.register_forward_hook(lambda m, i, o, name=name: acts.update({name: o.detach()}))
    tokens, chain = step_batch(kind, batch, seed, device)
    _reset_counters()
    m = step(tokens, chain, seed)
    out = {'loss': m['loss'].item(), 'launches': _counters(),
           'grad_norm': None if state.grad_norm is None else state.grad_norm.item(),
           'activations': {k: v.float().cpu() for k, v in acts.items()}}
    shards = mesh or M.Mesh()
    out['grads'] = {k: v.cpu() for k, v in M.gather_state_dict(grads, shards).items()}
    out['params'] = {k: v.cpu() for k, v in M.gather_state_dict(
        {n: p.detach() for n, p in model.named_parameters()}, shards).items()}
    return out


def profile_result(kind: str, test_size: bool, batch: int, seed: int, device,
                   mesh: Optional[M.Mesh], attempts: int = 3) -> dict:
    """One warm bf16 step under torch.profiler (``train_breakdown.
    profile_window``): this rank's K1-K4 launch counters over the profiled
    step beside the K1-K4 kernels the profiler saw. A step whose two
    readings differ (the profiler can drop a record) is profiled again, up
    to ``attempts`` times; ``attempts`` says how many it took."""
    from .train_breakdown import profile_window
    device = resolve_device(device)
    cfg = step_config(kind, test_size, 0.0)
    model, state, step = build_step(kind, cfg, torch.bfloat16, device, seed, mesh, 10.0)
    tokens, chain = step_batch(kind, batch, seed, device)
    counted = {}

    def window():
        _reset_counters()
        step(tokens, chain, seed)
        counted.update(_counters())

    for attempt in range(1, attempts + 1):
        prof = profile_window(window, device)
        seen = {k: prof['kernels_by_group'][k] for k in counted}
        if seen == counted:
            break
    return {'counted': dict(counted), 'profiled': seen, 'attempts': attempt,
            'device_ms_by_group': prof['device_ms_by_group'], 'window_ms': prof['window_ms']}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30)).item()


def compare_steps(got: dict, ref: dict) -> dict:
    """A parallel step against the one-process step: relative errors of
    the loss and the gradient norm; of the gradients and the updated
    parameters, the global ||got - ref|| / ||ref|| and the largest per
    tensor max |err| / max |ref| (with its tensor); and the key sets'
    agreement."""
    def glob(a, b):
        num = sum(((a[k].float() - b[k].float()) ** 2).sum().item() for k in b)
        return (num / sum((b[k].float() ** 2).sum().item() for k in b)) ** 0.5

    out = {'same_keys': sorted(got['grads']) == sorted(ref['grads'])
           and sorted(got['params']) == sorted(ref['params']),
           'loss_rel_err': abs(got['loss'] - ref['loss']) / abs(ref['loss'])}
    if ref['grad_norm'] is not None:
        out['grad_norm_rel_err'] = abs(got['grad_norm'] - ref['grad_norm']) / ref['grad_norm']
    if not out['same_keys']:
        return out
    for part in ('grads', 'params'):
        rel = {k: _rel(got[part][k], ref[part][k]) for k in ref[part]}
        worst = max(rel, key=rel.get)
        out[f'{part}_global_rel_err'] = glob(got[part], ref[part])
        out[f'{part}_max_rel_err'], out[f'{part}_worst'] = rel[worst], worst
    return out


def sample_result(pairs, ckpt: Optional[str], test_size: bool, batch: int, rows: int,
                  seed: int, fp32: bool, device, mesh: Optional[M.Mesh],
                  positions: Optional[int] = None) -> np.ndarray:
    """[inputs * rows, L] grids of one ``humanize_many`` call (device batch
    ``batch``), model from ``ckpt`` or random weights of ``seed``;
    ``positions`` keeps the first that many framework slots of each input
    (a round of that many forwards instead of all of them)."""
    from ..sampling import humanize as HZ
    device = resolve_device(device)
    if ckpt:
        model, _ = HZ.load_denoiser(ckpt, kind='pair', device=device, use_bf16=not fp32)
    else:
        cfg = DenoiserConfig().test_size() if test_size else DenoiserConfig()
        torch.manual_seed(seed)
        model = AntiTFNet(cfg, dtype=torch.float32 if fp32 else torch.bfloat16,
                          device=device)
    hum = HZ.PairHumanizer(model, batch_size=rows, seed=seed, device=device,
                           device_batch=batch, mesh=mesh)
    inputs = [HZ.pair_input(h, l) for h, l in pairs]
    if positions:
        for inp in inputs:
            inp['positions'] = inp['positions'][:positions]
    res = hum.humanize_many(inputs, rows_per_input=rows, pad_to=positions)
    return np.concatenate([r['grids'] for r in res])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('cmd', choices=['step', 'pretrain', 'sample'])
    p.add_argument('--out', required=True, help='directory of the ranks\' files')
    p.add_argument('--world', type=int, default=2)
    p.add_argument('--tp', type=int, default=1)
    p.add_argument('--device', default='cuda', help="'cuda' (default) or 'cpu'")
    p.add_argument('--kind', choices=['pair', 'heavy'], default='pair')
    p.add_argument('--test-size', action='store_true')
    p.add_argument('--fp32', action='store_true', help='f32 compute (default bf16)')
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--seed', type=int, default=7)
    p.add_argument('--dropout', type=float, default=0.0)
    p.add_argument('--clip-norm', type=float, default=None)
    p.add_argument('--profile', action='store_true', help='step: add a profiled bf16 step')
    p.add_argument('--config', default=None, help='pretrain: the run\'s YAML config')
    p.add_argument('--run-args', default='{}',
                   help='pretrain: JSON keywords of pretrain.run (max_iter, resume, ...)')
    p.add_argument('--pairs', default=None, help='sample: JSON file of [heavy, light] pairs')
    p.add_argument('--ckpt', default=None, help='sample: a port checkpoint')
    p.add_argument('--rows', type=int, default=8, help='sample: rows per pair')
    p.add_argument('--positions', type=int, default=None,
                   help='sample: framework slots resampled per input (default all)')
    p.add_argument('--timeout', type=float, default=600.0)
    p.add_argument('--rank', type=int, default=None)
    p.add_argument('--init-method', default=None)
    args = p.parse_args(argv)
    resolve_device(args.device)
    if args.rank is None:
        return launch(list(argv if argv is not None else sys.argv[1:]), args.world, args.out,
                      args.timeout)
    torch.set_num_threads(1 if args.device == 'cpu' else torch.get_num_threads())
    if args.device == 'cuda':   # the float32 comparisons: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dev = M.init_distributed('gloo', args.device, args.init_method, args.rank, args.world)
    try:
        result = _run(args, dev)
        torch.save(result, os.path.join(args.out, f'rank{args.rank}.pt'))
    finally:
        torch.distributed.destroy_process_group()


def _run(args, dev) -> dict:
    if args.cmd == 'pretrain':
        from ..training import pretrain as PT
        from ..utils.config import load_yaml
        cfg = load_yaml(args.config)
        kw = json.loads(args.run_args)
        kind = kw.pop('kind', 'pair')
        log_dir = PT.run(cfg, kind, None, os.path.join(args.out, 'logs'), device=dev,
                         tp=args.tp, **kw)
        return {'log_dir': log_dir}
    mesh = M.make_mesh(model_axis=args.tp)
    if args.cmd == 'sample':
        with open(args.pairs) as f:
            pairs = json.load(f)
        grids = sample_result(pairs, args.ckpt, args.test_size, args.batch, args.rows,
                              args.seed, args.fp32, dev, mesh, args.positions)
        return {'grids': grids}
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    res = step_result(args.kind, args.test_size, dtype, args.batch, args.seed, args.dropout,
                      args.clip_norm, dev, mesh)
    if args.profile:
        res['profile'] = profile_result(args.kind, args.test_size, args.batch, args.seed, dev,
                                        mesh)
    if mesh.rank:
        res.pop('grads', None)
        res.pop('params', None)
    res['mesh'] = {'dp': mesh.dp, 'tp': mesh.tp, 'dp_rank': mesh.dp_rank,
                   'tp_rank': mesh.tp_rank}
    return res


if __name__ == '__main__':
    main()
