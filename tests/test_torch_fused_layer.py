"""Port K8 (hudiff_tpu_torch/tools/fused_layer_probe.py: ``fused_layer``
and its plain version) against the TPU kernel of tools/fused_layer_probe.py,
and the layout finding of that probe.

The JAX ``fused_layer`` refuses the CPU ("Only interpret mode is supported
on CPU backend"), so the test builds the same ``pl.pallas_call`` over
``_fused_layer_kernel`` with the BlockSpecs of tools/fused_layer_probe.py:
76-86 and ``interpret=True``. Inputs and weights are made with numpy from
a seed and fed to both packages; on the CPU the port's ``fused_layer`` runs
its plain version.

Tolerances. f32: max |out - ref| <= 1e-5 max |ref| (768-term and 64-term
products and an L-term softmax summed in other orders). bf16: elementwise
|out - ref| <= 2**-7 |ref| + 5e-3 max |ref|: both sides round y to bf16 and
may round it one spacing apart (the 2**-7 |ref| term); the rest comes from
qkv, P or o rounded to bf16 on either side of a rounding boundary (over
the weights of seeds 0-3 at this shape the largest reading was 1.4e-3 of
max |ref|).

The layout finding: the TPU kernel reads the qkv projection's columns
column-blocked ([Q | K | V], tools/fused_layer_probe.py:47-51); the JAX
probe's ``current_layer`` reads the same columns head-major
(pallas_attention.py:196-202), so the two differ by far more than rounding
on the probe's own weights. The port's ``current_layer`` on
``column_blocked_to_head_major`` of those weights computes K8's function.
"""
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from hudiff_tpu.ops import pallas_attention as JPA
from hudiff_tpu.ops import rope as JROPE
from hudiff_tpu_torch.ops import fused_attention as FA
from hudiff_tpu_torch.ops import rope as ROPE
from hudiff_tpu_torch.tools import fused_layer_probe as FL

REPO = Path(__file__).resolve().parents[1]
B, L, DM, HEADS, HD = 2, 37, 128, 2, 64
ATT = HEADS * HD
SCALE = 1.0 / np.sqrt(HD)
BF16_RTOL = 2.0 ** -7


def _jax_probe():
    """tools/fused_layer_probe.py, loaded from its file (tools/ is not a
    package)."""
    spec = importlib.util.spec_from_file_location('jax_fused_layer_probe',
                                                  REPO / 'tools' / 'fused_layer_probe.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JFL = _jax_probe()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist
    workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(seed):
    """x and column-blocked weights, f32 numpy."""
    rs = np.random.RandomState(seed)
    return [a.astype(np.float32) for a in (
        rs.randn(B, L, DM) * 0.5, rs.randn(DM, 3 * ATT) / np.sqrt(DM),
        rs.randn(3 * ATT) * 0.1, rs.randn(ATT, DM) / np.sqrt(ATT), rs.randn(DM) * 0.1)]


def _pallas_interpret(x, wqkv, bqkv, wout, bout, cos, sin):
    """The TPU kernel, as tools/fused_layer_probe.py:67-87 calls it, in
    interpret mode."""
    Bx, Lx, dm = x.shape
    kern = functools.partial(JFL._fused_layer_kernel, scale=SCALE, heads=HEADS, head_dim=HD)
    cf = jnp.concatenate([cos, cos], axis=1).astype(jnp.float32)
    sf = jnp.concatenate([sin, sin], axis=1).astype(jnp.float32)
    return pl.pallas_call(
        kern, grid=(Bx,),
        in_specs=[pl.BlockSpec((1, Lx, dm), lambda b: (b, 0, 0)),
                  pl.BlockSpec(wqkv.shape, lambda b: (0, 0)),
                  pl.BlockSpec(bqkv.shape, lambda b: (0,)),
                  pl.BlockSpec(wout.shape, lambda b: (0, 0)),
                  pl.BlockSpec(bout.shape, lambda b: (0,)),
                  pl.BlockSpec((Lx, HD), lambda b: (0, 0)),
                  pl.BlockSpec((Lx, HD), lambda b: (0, 0)),
                  pl.BlockSpec((HD, HD), lambda b: (0, 0))],
        out_specs=pl.BlockSpec((1, Lx, dm), lambda b: (b, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((Bx, Lx, dm), x.dtype),
        interpret=True,
    )(x, wqkv, bqkv, wout, bout, cf, sf, JPA._rot_matrix(HD))


def _both(arrays, jdt, tdt):
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(a):
    return a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32)


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_fused_layer_matches_pallas_interpret(dt):
    jdt, tdt = {'f32': (jnp.float32, torch.float32),
                'bf16': (jnp.bfloat16, torch.bfloat16)}[dt]
    jarr, tarr = _both(_weights(0), jdt, tdt)
    ref = _f32(_pallas_interpret(*jarr, *JROPE.rope_tables(HD, L)))
    before = FL.launches
    out = FL.fused_layer(*tarr, *ROPE.rope_tables(HD, L), SCALE, HEADS)
    assert FL.launches == before   # CPU tensors never launch the kernels
    assert out.shape == (B, L, DM) and out.dtype == tdt
    np.testing.assert_array_equal(
        out.numpy() if dt == 'f32' else _f32(out),
        _f32(FL.fused_layer_reference(*tarr, *ROPE.rope_tables(HD, L), SCALE, HEADS)))
    diff = np.abs(_f32(out) - ref)
    peak = np.abs(ref).max()
    if dt == 'f32':
        assert diff.max() <= 1e-5 * peak, diff.max() / peak
    else:
        excess = (diff - BF16_RTOL * np.abs(ref)).max()
        assert excess <= 5e-3 * peak, excess / peak


def test_probe_layouts_differ_and_the_port_permutes_the_weights():
    """JAX's ``current_layer`` on the probe's column-blocked weights is
    another function than the TPU kernel; on the head-major permutation of
    the same weights it is the same function, and so is the port's
    ``current_layer``."""
    x, wqkv, bqkv, wout, bout = _weights(1)
    cos_j, sin_j = JROPE.rope_tables(HD, L)
    cos_t, sin_t = ROPE.rope_tables(HD, L)
    j = [jnp.asarray(a) for a in (x, wqkv, bqkv, wout, bout)]
    kernel = _f32(_pallas_interpret(*j, cos_j, sin_j))
    peak = np.abs(kernel).max()
    as_is = _f32(JFL.current_layer(*j, cos_j, sin_j, SCALE, HEADS))
    assert np.abs(as_is - kernel).max() > 0.1 * peak   # two different functions

    t = [torch.from_numpy(a) for a in (x, wqkv, bqkv, wout, bout)]
    w_hm, b_hm = FL.column_blocked_to_head_major(t[1], t[2], HEADS)
    permuted = _f32(JFL.current_layer(j[0], jnp.asarray(w_hm.numpy()), jnp.asarray(b_hm.numpy()),
                                      j[3], j[4], cos_j, sin_j, SCALE, HEADS))
    assert np.abs(permuted - kernel).max() <= 1e-5 * peak
    port = FL.current_layer(t[0], w_hm, b_hm, t[3], t[4], cos_t, sin_t, SCALE, HEADS)
    ref = FL.fused_layer_reference(*t, cos_t, sin_t, SCALE, HEADS)
    assert np.abs(_f32(port) - _f32(ref)).max() <= 1e-5 * np.abs(_f32(ref)).max()
    assert np.abs(_f32(port) - kernel).max() <= 1e-5 * peak


def test_column_blocked_to_head_major_is_merge_qkv_heads_on_columns():
    _, wqkv, bqkv, _, _ = _weights(2)
    w_hm, b_hm = FL.column_blocked_to_head_major(torch.from_numpy(wqkv),
                                                 torch.from_numpy(bqkv), HEADS)
    for got, a in ((w_hm, wqkv), (b_hm, bqkv[None])):
        a3 = jnp.asarray(a)[None]   # [1, rows, 3A]: rows stand for positions
        want = JPA.merge_qkv_heads(a3[..., :ATT], a3[..., ATT:2 * ATT], a3[..., 2 * ATT:],
                                   HEADS)[0]
        np.testing.assert_array_equal(got.reshape(want.shape).numpy(), np.asarray(want))
    # and the head-major qkv of the permuted weights splits into the same q, k, v
    x = torch.from_numpy(_weights(2)[0])
    q, k, v = FA.split_qkv_heads(x @ w_hm + b_hm, HEADS)
    qkv = x @ torch.from_numpy(wqkv) + torch.from_numpy(bqkv)
    for got, want in zip((q, k, v), qkv.split(ATT, dim=-1)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize('fp32', [False, True])
def test_probe_cli_on_the_cpu(capsys, fp32):
    if fp32:
        rec = FL.measure('cpu', 1, torch.float32, 1)
    else:
        FL.main(['--device', 'cpu', '--batch', '1'])
        rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {'current_ms', 'fused_ms', 'speedup', 'rel_err'} <= set(rec)
    assert rec['device'] == 'cpu' and rec['L'] == 291 and rec['d_model'] == 768
    assert rec['dtype'] == ('float32' if fp32 else 'bfloat16')
    assert np.isfinite([rec['current_ms'], rec['fused_ms'], rec['speedup']]).all()
    # one function on both sides: f32 rounding alone, bf16 one spacing of y
    assert rec['rel_err'] <= (1e-5 if fp32 else 2.0 ** -7)
