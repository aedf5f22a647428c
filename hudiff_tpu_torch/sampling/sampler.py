"""Reverse OA-ARDM sampling.

Counterpart of hudiff_tpu/sampling/sampler.py (``make_scan_sampler`` with
any ``positions_per_step``, ``make_jit_sampler``, ``build_order``,
``build_order_rows`` and ``sequential_reference_sampler``). The JAX package
runs the loop as one ``lax.scan``, jitted into one program per shape
(``make_jit_sampler``). Here each step:

- runs one full forward, gathers every row's logits at its own k
  positions, draws a categorical over ``logits[..., :22]`` in f32 from an
  explicit ``torch.Generator`` on the model's device (Gumbel-max), and
  writes the tokens back;
- treats an order slot of -1 as a no-op, so rows with fewer masked
  positions share one ``[B, K]`` order matrix.

``make_scan_sampler`` is that loop in Python, with no host
synchronisation: about 240 kernel launches a step from the host.
``make_graph_sampler`` is ``make_jit_sampler``'s counterpart on the card:
one step captured as a CUDA graph per shape and replayed once a step, the
step's positions read on the device at a step counter the graph advances
(``RoundBuffers``). ``make_model_sampler`` gives the graph round to a model
on a card and the loop to one on the CPU.

``sequential_reference_sampler`` keeps the reference's cost structure
instead: one forward per position, the tokens read back to the host after
each draw.

A batch split over ranks (the humanize CLI's ``--shard``) samples the
same tokens: each rank runs its rows, and every step draws the whole
batch's noise from the shared seed and keeps those rows (``rows=``), as
JAX's sharded scan draws ``[B, ...]`` noise whatever the sharding.
"""
from __future__ import annotations

import dataclasses
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


def _launch_counts():
    """{(module, name): value} of every kernel launch counter a step can
    move (``COUNTERS`` of ops/fused_attention.py and ops/fused_bytenet.py)."""
    from ..ops import fused_attention as FA
    from ..ops import fused_bytenet as FB
    return {(m, n): getattr(m, n) for m in (FA, FB) for n in m.COUNTERS}


def _add_launches(counts) -> None:
    for (m, n), d in counts.items():
        setattr(m, n, getattr(m, n) + d)


class RoundBuffers:
    """The static state of a graph round and ``step()``, the body its graph
    captures; uncaptured, it runs on any device.

    - ``buf`` [B, L + 1]: the grid; column L takes the writes of -1 slots;
    - ``order`` [B, S, k]: the order as steps, padded with -1 to S = ceil(
      max(``width``, L) / k) steps, the widest order it takes;
    - ``cond``: the conditioning; ``counter``: the step index, [1] int64;
    - ``generator``: its own, on the device: ``load`` sets it to the
      caller's state and ``finish`` hands the advanced state back, so that
      a graph registers one generator whichever the caller passes.

    A step reads its positions at ``counter``, runs one forward over the
    grid, draws its k positions and writes them back as
    ``make_scan_sampler``'s step does, and advances ``counter``; it returns
    the logits."""

    def __init__(self, apply_fn: Callable[..., torch.Tensor], positions_per_step: int,
                 tokens: torch.Tensor, cond: Sequence[torch.Tensor], width: int,
                 rows: Optional[Tuple[int, int]] = None):
        B, L = tokens.shape
        dev = tokens.device
        self.apply_fn, self.k, self.rows, self.L = apply_fn, positions_per_step, rows, L
        self.buf = tokens.new_zeros(B, L + 1)
        self.order = torch.full((B, -(-max(width, L) // self.k), self.k), -1,
                                dtype=torch.long, device=dev)
        self.cond = [c.clone() for c in cond]
        self.counter = torch.zeros(1, dtype=torch.long, device=dev)
        self.row_ix = torch.arange(B, device=dev)[:, None]
        self.generator = torch.Generator(device=dev)

    @property
    def width(self) -> int:
        return self.order.shape[1] * self.k

    def load(self, tokens: torch.Tensor, order: torch.Tensor, generator: torch.Generator,
             cond: Sequence[torch.Tensor]) -> int:
        """Copy a round's inputs in and zero the step counter; returns its
        steps, ceil(order width / k)."""
        B = tokens.shape[0]
        self.buf[:, :self.L].copy_(tokens)
        flat = self.order.view(B, -1)
        flat.fill_(-1)
        flat[:, :order.shape[1]].copy_(order)
        for static, c in zip(self.cond, cond):
            static.copy_(c)
        self.counter.zero_()
        self.generator.set_state(generator.get_state())
        return -(-order.shape[1] // self.k)

    def step(self) -> torch.Tensor:
        pos = self.order.index_select(1, self.counter)[:, 0]       # [B, k]
        valid = pos >= 0
        logits = self.apply_fn(self.buf[:, :self.L], *self.cond)  # [B, L, V]
        sel = logits[self.row_ix, torch.where(valid, pos, 0), :SAMPLE_TOP]
        self.buf[self.row_ix, torch.where(valid, pos, self.L)] = categorical(
            sel, self.generator, self.rows).to(self.buf.dtype)
        self.counter += 1
        return logits

    def finish(self, generator: torch.Generator) -> torch.Tensor:
        """Advance ``generator`` to this round's end; returns the grid."""
        generator.set_state(self.generator.get_state())
        return self.buf[:, :self.L].clone()


@dataclasses.dataclass
class GraphRound:
    """One shape's buffers, its captured step (``graph``; its output
    ``logits`` hold the last replayed step's) and the kernel launches one
    replay makes (``launches``, by counter)."""
    buffers: RoundBuffers
    graph: torch.cuda.CUDAGraph
    logits: torch.Tensor
    launches: dict

    def replay(self, n: int = 1) -> None:
        """``n`` steps: each a replay, its kernels added to the counters."""
        for _ in range(n):
            self.graph.replay()
            _add_launches(self.launches)


class GraphSampler:
    """``make_graph_sampler``'s sampler; ``rounds`` holds one
    ``GraphRound`` per key (B, L, k, ``rows``, dtypes and shapes of the
    tokens and the conditioning, device)."""

    def __init__(self, apply_fn: Callable[..., torch.Tensor], positions_per_step: int = 1):
        self.apply_fn = apply_fn
        self.k = max(1, positions_per_step)
        self.rounds: dict = {}
        self.pool = None

    @torch.inference_mode()
    def __call__(self, tokens: torch.Tensor, order: torch.Tensor, generator: torch.Generator,
                 *cond, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if tokens.device.type != 'cuda':
            raise ValueError(f'make_graph_sampler: a CUDA graph needs CUDA tensors, not '
                             f'{tokens.device} (make_scan_sampler runs on the CPU)')
        key = (tuple(tokens.shape), tokens.dtype, tokens.device, self.k, rows,
               tuple((tuple(c.shape), c.dtype) for c in cond))
        with torch.cuda.device(tokens.device):
            entry = self.rounds.get(key)
            if entry is None or entry.buffers.width < order.shape[1]:
                self.rounds.pop(key, None)
                buffers = RoundBuffers(self.apply_fn, self.k, tokens, cond, order.shape[1],
                                       rows)
                n = buffers.load(tokens, order, generator, cond)
                if n == 0:
                    return buffers.finish(generator)
                entry = self.rounds[key] = self._capture(buffers)
                n -= 1
            else:
                n = entry.buffers.load(tokens, order, generator, cond)
            entry.replay(n)
            return entry.buffers.finish(generator)

    def _capture(self, buffers: RoundBuffers) -> GraphRound:
        """Run the round's first step eagerly on a side stream (it loads
        every kernel's library and sets its attributes, which a capture may
        not), then capture the next step there. The capture's launch counts
        are taken back: its kernels did not run."""
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            buffers.step()
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(buffers.generator)
        before = _launch_counts()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                                  capture_error_mode='thread_local'):
                logits = buffers.step()
        finally:
            after = _launch_counts()
            _add_launches({c: before[c] - after[c] for c in before})
        torch.cuda.current_stream().wait_stream(stream)
        return GraphRound(buffers, graph, logits,
                          {c: after[c] - before[c] for c in before if after[c] != before[c]})


def make_graph_sampler(apply_fn: Callable[..., torch.Tensor], positions_per_step: int = 1):
    """``make_scan_sampler``'s sampler as CUDA graph replays, the counterpart
    of ``make_jit_sampler``'s one program per shape: same call, same tokens
    from the same generator state.

    The first round of a key runs its first step eagerly, then captures
    one step (forward, gather, draw, write-back, counter) into a
    ``torch.cuda.CUDAGraph``; every round after copies its tokens, order
    and conditioning into that key's buffers, zeroes the counter and
    replays the graph once a step: one host call a step, no
    synchronisation. The graph registers the buffers' generator, so each
    replay draws new noise and advances it as the eager draw would. The
    graphs of one sampler share one memory pool: one round runs at a time,
    and the only output a graph keeps is its logits, read right after its
    own replay. Captures run under ``capture_error_mode='thread_local'``,
    so that other threads (the service's handlers) may call CUDA meanwhile.
    A failed capture or replay raises; a CPU tensor raises."""
    return GraphSampler(apply_fn, positions_per_step)


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
    """``run(tokens, order, generator, *cond, rows=None) -> tokens`` for a
    denoiser conditioned on ``cond``: ``(region, chain)`` for the paired
    one, ``(region,)`` for the nanobody one (``make_jit_sampler`` with and
    without ``has_chain_type``). Puts the model in eval mode and applies
    ``cast_params_once`` to it. A model on a card gets graph rounds
    (``make_graph_sampler``), one on the CPU (or with no parameters) the
    eager loop."""
    model = cast_params_once(model.eval())
    param = next(model.parameters(), None)
    on_card = param is not None and param.device.type == 'cuda'
    return (make_graph_sampler if on_card else make_scan_sampler)(
        model, positions_per_step=positions_per_step)


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
