"""The plain K2 and K4 (hudiff_tpu_torch/ops/fused_bytenet.py) in bf16
against the JAX package's Pallas kernels ``_pallas_fwd`` / ``_pallas_bwd``
in interpret mode, in bf16.

On a card the CUDA kernels are held against these plain versions in bf16
(tests/test_torch_kernels_cuda.py, chip_smoke.py); tests/test_torch_bytenet.py
and tests/test_torch_backward.py hold them against JAX in f32 only. Here the
same numpy inputs, with x and dy rounded to bf16 and the parameters f32 (the
kernels round the weights to bf16 themselves), go through both. The backward
is given the Pallas forward's p and q on both sides, so each direction is
held on its own.

Tolerances: an output is held elementwise to |out - ref| <= 2**-7 |ref| +
excess, the parameter gradients (f32 sums over B*L rows) by
max |err| <= rtol max |ref|. Both sides round a, p, bb, q, e, dq and dp to
bf16, from f32 sums taken in other orders, and the Pallas GELU uses a
1.5e-7 rational erf where the port takes the exact one, so an intermediate
may round one bf16 spacing apart. One rounding point differs: the plain
forward rounds each LayerNorm's output to bf16 before the activation (its
``layer_norm`` returns x's type, as the Flax module path does), where the
Pallas kernel, and the CUDA kernel, activate the f32 value. For ReLU that
is the same value; for GELU it moves p, q and y by up to about two bf16
spacings. So the forward is held to the card's K2 limit (excess 2.5e-2;
largest readings here, all GELU: p 8.5e-3, q 1.4e-2, y 2.1e-2), and a
second test holds the Pallas forward against the same plain stages with
the LayerNorm output kept in f32, where the excess is what one rounding
flip carries (limit 1e-2, largest reading 5.6e-3). The same two limits
hold at the nano_conv tower's width, D 512 / H 256 GELU at L = 17
(largest readings, y: 1.7e-2 as the plain version rounds, 4.8e-3 kept in
f32). The backward has no such point: dx excess 1e-3 (largest reading 9.5e-5), gradients rtol 1e-3
(largest reading 9.8e-5). The residual-taking plain backward (given the
rows' LayerNorm statistics, as K2 writes them for K4) is held to the same
limits, given statistics taken from the same rows in f32.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from hudiff_tpu.ops import pallas_bytenet as JPB
from hudiff_tpu_torch.ops import fused_bytenet as FB

D, H, K, B = 64, 32, 7, 2
BF16_RTOL = 2.0 ** -7
Y_EXCESS = 2.5e-2
Y_EXCESS_F32_LN = 1e-2
DX_EXCESS = 1e-3
GRAD_RTOL = 1e-3
CASES = [(act, dil, L) for act in ('relu', 'gelu') for dil in (1, 4, 32) for L in (17, 139)]
NANO_DH, NANO_L = (512, 256), 17   # the nano_conv tower (configs/heavy_train.yml)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (the suite runs in several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block(seed, L, D=D, H=H):
    """(Flax-layout parameters, x, dy) from a seed, all f32."""
    rs = np.random.RandomState(seed)
    n = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    prm = dict(g1=1 + 0.1 * n(D), b1=0.1 * n(D), w1=n(D, H) / D ** 0.5, c1=0.1 * n(H),
               g2=1 + 0.1 * n(H), b2=0.1 * n(H), wc=n(K, H, H) / (K * H) ** 0.5,
               cc=0.1 * n(H), g3=1 + 0.1 * n(H), b3=0.1 * n(H), w2=n(H, D) / H ** 0.5,
               c2=0.1 * n(D))
    return prm, n(B, L, D), n(B, L, D)


def _jax_params(prm):
    return JPB._pack(*(jnp.asarray(prm[k]) for k in FB_ORDER))


FB_ORDER = ('g1', 'b1', 'w1', 'c1', 'g2', 'b2', 'wc', 'cc', 'g3', 'b3', 'w2', 'c2')


def _port_params(prm):
    """The port's layouts: w1 [H, D], wc [H, K, H] (out, tap, in), w2 [D, H]."""
    lay = {'w1': lambda w: w.T, 'wc': lambda w: w.transpose(2, 0, 1), 'w2': lambda w: w.T}
    return [torch.from_numpy(np.ascontiguousarray(lay.get(k, lambda w: w)(prm[k])))
            for k in FB_ORDER]


def _bf16(a):
    """An f32 numpy array, or a JAX bf16 array, as a torch bf16 tensor."""
    if not isinstance(a, np.ndarray):
        a = np.asarray(a.astype(jnp.float32))
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _excess(out, ref):
    out, ref = out.float(), ref.float()
    return ((out - ref).abs() - BF16_RTOL * ref.abs()).max().item()


def _forwards(act, dil, L, D=D, H=H):
    """(Pallas (y, p, q), plain (y, p, q)) on one block's bf16 input."""
    prm, x, _ = _block(dil * 100 + L + (act == 'gelu'), L, D, H)
    y_j, _, p_j, q_j = JPB._pallas_fwd(jnp.asarray(x, jnp.bfloat16), _jax_params(prm), K, dil,
                                       act, True)
    plain = FB._reference_parts(_bf16(x), *_port_params(prm), dilation=dil,
                                activation_name=act)
    return (_bf16(y_j), _bf16(p_j[:, :L]), _bf16(q_j[:, :L])), plain


@pytest.mark.parametrize('act,dil,L', CASES)
def test_plain_k2_bf16_matches_pallas_fwd(act, dil, L):
    pallas, plain = _forwards(act, dil, L)
    assert all(t.dtype == torch.bfloat16 for t in plain)
    for name, got, ref in zip('ypq', plain, pallas):
        err = _excess(got, ref)
        assert err <= Y_EXCESS, f'{name} excess {err} over {BF16_RTOL} |ref|'


@pytest.mark.parametrize('dil,L', [(dil, L) for _, dil, L in CASES[len(CASES) // 2:]])
def test_pallas_fwd_activates_the_layernorm_output_in_f32(monkeypatch, dil, L):
    """With each LayerNorm's output kept in f32 before GELU, the plain
    stages agree with the Pallas forward to one rounding flip."""
    monkeypatch.setattr(FB, 'layer_norm', lambda x, g, b: F.layer_norm(
        x.float(), (x.shape[-1],), g.float(), b.float(), FB.LN_EPS))
    pallas, plain = _forwards('gelu', dil, L)
    for name, got, ref in zip('ypq', plain, pallas):
        err = _excess(got, ref)
        assert err <= Y_EXCESS_F32_LN, f'{name} excess {err} over {BF16_RTOL} |ref|'


@pytest.mark.parametrize('dil', [1, 32])
def test_plain_k2_bf16_matches_pallas_fwd_nano_conv_width(dil, monkeypatch):
    """The nano_conv tower's width (D 512, H 256, GELU) at L = 17: the plain
    forward against the Pallas one, to the same limit, and with the
    LayerNorm output kept in f32 to the tighter one."""
    pallas, plain = _forwards('gelu', dil, NANO_L, *NANO_DH)
    for name, got, ref in zip('ypq', plain, pallas):
        err = _excess(got, ref)
        assert err <= Y_EXCESS, f'{name} excess {err} over {BF16_RTOL} |ref|'
    monkeypatch.setattr(FB, 'layer_norm', lambda x, g, b: F.layer_norm(
        x.float(), (x.shape[-1],), g.float(), b.float(), FB.LN_EPS))
    pallas, plain = _forwards('gelu', dil, NANO_L, *NANO_DH)
    for name, got, ref in zip('ypq', plain, pallas):
        err = _excess(got, ref)
        assert err <= Y_EXCESS_F32_LN, f'{name} excess {err} over {BF16_RTOL} |ref| (f32 LN)'


@pytest.mark.parametrize('act,dil,L', CASES)
def test_plain_k4_bf16_matches_pallas_bwd(act, dil, L):
    _check_k4(act, dil, L)


@pytest.mark.parametrize('dil', [1, 32])
def test_plain_k4_bf16_matches_pallas_bwd_nano_conv_width(dil):
    _check_k4('gelu', dil, NANO_L, *NANO_DH)


def _check_k4(act, dil, L, D=D, H=H):
    prm, x, dy = _block(dil * 100 + L + 7 * (act == 'gelu'), L, D, H)
    packed = _jax_params(prm)
    _, xp, p_j, q_j = JPB._pallas_fwd(jnp.asarray(x, jnp.bfloat16), packed, K, dil, act, True)
    outs = JPB._pallas_bwd(xp, p_j, q_j, packed, jnp.asarray(dy, jnp.bfloat16), K, dil, act,
                           True)
    got = FB.bytenet_block_backward_reference(
        _bf16(x), _bf16(p_j[:, :L]), _bf16(q_j[:, :L]), *_port_params(prm), _bf16(dy),
        dilation=dil, activation_name=act)
    assert got[0].dtype == torch.bfloat16
    err = _excess(got[0], _bf16(outs[0]))
    assert err <= DX_EXCESS, f'dx excess {err} over {BF16_RTOL} |ref|'
    # the Pallas gradients in the Flax layouts, the vectors as (1, N) rows
    ref = _port_params({k: np.asarray(g)[0] if g.shape[0] == 1 else np.asarray(g)
                        for k, g in zip(FB_ORDER, outs[1:])})
    for name, g, r in zip(FB_ORDER, got[1:], ref):
        assert g.shape == r.shape and g.dtype == torch.float32, name
        rel = ((g - r).abs().max() / r.abs().max()).item()
        assert rel <= GRAD_RTOL, f'{name}: {rel}'


def _row_stats(z):
    """[B, L, 2] f32 (mean, 1/sigma) of z's rows, the fast variance."""
    zf = z.float()
    mu = zf.mean(-1)
    inv = torch.rsqrt(((zf * zf).mean(-1) - mu * mu).clamp_min(0.0) + FB.LN_EPS)
    return torch.stack([mu, inv], -1)


@pytest.mark.parametrize('act,dil,L', CASES[::3])
def test_plain_k4_given_the_statistics_matches_pallas_bwd(act, dil, L):
    prm, x, dy = _block(dil * 100 + L + 7 * (act == 'gelu'), L)
    packed = _jax_params(prm)
    _, xp, p_j, q_j = JPB._pallas_fwd(jnp.asarray(x, jnp.bfloat16), packed, K, dil, act, True)
    outs = JPB._pallas_bwd(xp, p_j, q_j, packed, jnp.asarray(dy, jnp.bfloat16), K, dil, act,
                           True)
    xt, pt, qt = _bf16(x), _bf16(p_j[:, :L]), _bf16(q_j[:, :L])
    stats = torch.stack([_row_stats(t) for t in (xt, pt, qt)])
    got = FB.bytenet_block_backward_reference(xt, pt, qt, *_port_params(prm), _bf16(dy),
                                              dilation=dil, activation_name=act, stats=stats)
    err = _excess(got[0], _bf16(outs[0]))
    assert err <= DX_EXCESS, f'dx excess {err} over {BF16_RTOL} |ref|'
    ref = _port_params({k: np.asarray(g)[0] if g.shape[0] == 1 else np.asarray(g)
                        for k, g in zip(FB_ORDER, outs[1:])})
    for name, g, r in zip(FB_ORDER, got[1:], ref):
        rel = ((g - r).abs().max() / r.abs().max()).item()
        assert rel <= GRAD_RTOL, f'{name}: {rel}'

