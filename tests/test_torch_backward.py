"""The plain versions of K3 and K4 (the backward kernels of
hudiff_tpu_torch/ops/fused_attention.py and ops/fused_bytenet.py) against
the JAX package's Pallas backward kernels, and against torch autograd
through the port's plain forwards.

Inputs, weights and output gradients are made with numpy from a seed and
fed to both packages. The JAX side differentiates through its custom VJPs
with the Pallas kernels in interpret mode (``use_pallas='always'``), as
tests/test_pallas_attention.py and tests/test_pallas_bytenet.py do. f32
throughout. Tolerances: K3 atol 1e-5 (64-term products and a <= 291-term
softmax summed in other orders); K4 dx atol 1e-5, parameter gradients
max |err| <= 1e-5 max |ref| (sums over B*L <= 304 rows in other orders;
the Pallas GELU uses a 1.5e-7 erf approximation, the port the exact erf).

The CUDA kernels are held against these plain versions on a card in
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu.ops import pallas_attention as JPA
from hudiff_tpu.ops import rope as JROPE
from hudiff_tpu.ops.bytenet import ByteNetBlock as JBlock
from hudiff_tpu_torch.ops import fused_attention as FA
from hudiff_tpu_torch.ops import fused_bytenet as FB
from hudiff_tpu_torch.ops import rope as ROPE

# f32 is compared: no TF32 in matmuls or convolutions (a card would use it)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HEADS, HD = 8, 64
PARAMS = ('g1', 'b1', 'w1', 'c1', 'g2', 'b2', 'wc', 'cc', 'g3', 'b3', 'w2', 'c2')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist workers
    at once, and torch's default of a thread per core oversubscribes the
    cores, which slows these many small ops several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel_err(out, ref):
    out, ref = _np(out), _np(ref)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# -- K3 ----------------------------------------------------------------------

def _k3_inputs(B, L, seed):
    rs = np.random.RandomState(seed)
    qkv = rs.randn(B, L, HEADS * 3 * HD).astype(np.float32)
    do = rs.randn(B, L, HEADS * HD).astype(np.float32)
    return qkv, do


@pytest.mark.parametrize('L', [17, 139])
def test_k3_plain_matches_pallas_interpret_grad(L):
    qkv, do = _k3_inputs(2, L, L)
    cos_j, sin_j = JROPE.rope_tables(HD, L)
    cos_t, sin_t = ROPE.rope_tables(HD, L)
    scale = 1.0 / np.sqrt(HD)
    _, vjp = jax.vjp(lambda t: JPA.rope_attention_qkv(t, cos_j, sin_j, scale, HEADS,
                                                      use_pallas='always'), jnp.asarray(qkv))
    (ref,) = vjp(jnp.asarray(do))
    out = FA.rope_attention_qkv_backward_reference(
        torch.from_numpy(qkv), cos_t, sin_t, torch.from_numpy(do), scale, HEADS)
    assert out.shape == qkv.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_k3_plain_matches_autograd_and_the_function():
    """The plain backward against torch autograd through the plain forward,
    and ``RopeAttentionQKV`` (K1 forward, K3 backward) on CPU tensors."""
    qkv, do = _k3_inputs(2, 23, 5)
    cos, sin = ROPE.rope_tables(HD, 23)
    q = torch.from_numpy(qkv).requires_grad_()
    FA.rope_attention_qkv_reference(q, cos, sin, 0.125, HEADS).backward(torch.from_numpy(do))
    plain = FA.rope_attention_qkv_backward_reference(
        torch.from_numpy(qkv), cos, sin, torch.from_numpy(do), 0.125, HEADS)
    np.testing.assert_allclose(plain.numpy(), q.grad.numpy(), rtol=0, atol=1e-5)
    q2 = torch.from_numpy(qkv).requires_grad_()
    before = (FA.launches, FA.bwd_launches)
    out = FA.rope_attention_qkv(q2, cos, sin, 0.125, HEADS)
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(do))
    assert (FA.launches, FA.bwd_launches) == before  # CPU tensors launch nothing
    np.testing.assert_array_equal(q2.grad.numpy(), plain.numpy())


# -- K4 ----------------------------------------------------------------------

def _flax_block(rs, d, h, k):
    n = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    ln = lambda m: {'scale': 1 + 0.1 * n(m), 'bias': 0.1 * n(m)}  # noqa: E731
    return {'LayerNorm_0': ln(d), 'Dense_0': {'kernel': n(d, h) / d ** 0.5, 'bias': 0.1 * n(h)},
            'LayerNorm_1': ln(h),
            'DilatedConv1d_0': {'Conv_0': {'kernel': n(k, h, h) / (k * h) ** 0.5,
                                           'bias': 0.1 * n(h)}},
            'LayerNorm_2': ln(h), 'Dense_1': {'kernel': n(h, d) / h ** 0.5, 'bias': 0.1 * n(d)}}


def _port_params(p):
    """The Flax block tree (parameters or their gradients) in the port's
    order and layouts: w1 [H, D], wc [H, K, H] (out, tap, in), w2 [D, H]."""
    conv = p['DilatedConv1d_0']['Conv_0']
    out = (p['LayerNorm_0']['scale'], p['LayerNorm_0']['bias'],
           np.asarray(p['Dense_0']['kernel']).T, p['Dense_0']['bias'],
           p['LayerNorm_1']['scale'], p['LayerNorm_1']['bias'],
           np.asarray(conv['kernel']).transpose(2, 0, 1), conv['bias'],
           p['LayerNorm_2']['scale'], p['LayerNorm_2']['bias'],
           np.asarray(p['Dense_1']['kernel']).T, p['Dense_1']['bias'])
    return [torch.tensor(np.ascontiguousarray(np.asarray(t))) for t in out]


D, H, K = 32, 16, 7


@pytest.mark.parametrize('act,dil,L', [('relu', 1, 152), ('gelu', 4, 139),
                                       ('gelu', 32, 152), ('relu', 16, 139)])
def test_k4_plain_matches_pallas_interpret_grad(act, dil, L):
    rs = np.random.RandomState(dil * 100 + L)
    p = _flax_block(rs, D, H, K)
    x = rs.randn(2, L, D).astype(np.float32)
    dy = rs.randn(2, L, D).astype(np.float32)
    block = JBlock(H, D, K, dilation=dil, activation=act, use_pallas='always')
    _, vjp = jax.vjp(lambda prm, xin: block.apply({'params': prm}, xin), p, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    params = _port_params(p)
    xt = torch.from_numpy(x)
    _, pt, qt = FB._reference_parts(xt, *params, dilation=dil, activation_name=act)
    grads = FB.bytenet_block_backward_reference(xt, pt, qt, *params, torch.from_numpy(dy),
                                                dilation=dil, activation_name=act)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx), rtol=0, atol=1e-5)
    for name, got, ref in zip(PARAMS, grads[1:], _port_params(gp)):
        assert got.shape == ref.shape and got.dtype == torch.float32, name
        assert _rel_err(got, ref) <= 1e-5, name


@pytest.mark.parametrize('act,dil', [('relu', 2), ('gelu', 8)])
def test_k4_plain_matches_autograd_and_the_function(act, dil):
    """The plain backward against torch autograd through the plain forward,
    and ``ByteNetBlockFn`` (K2 forward keeping p and q, K4 backward) on CPU
    tensors, where it must launch nothing."""
    rs = np.random.RandomState(dil)
    params = _port_params(_flax_block(rs, D, H, K))
    x = torch.from_numpy(rs.randn(3, 41, D).astype(np.float32))
    dy = torch.from_numpy(rs.randn(3, 41, D).astype(np.float32))
    kw = dict(dilation=dil, activation_name=act)
    leaves = [t.clone().requires_grad_() for t in (x, *params)]
    FB.bytenet_block_reference(*leaves, **kw).backward(dy)
    _, p, q = FB._reference_parts(x, *params, **kw)
    plain = FB.bytenet_block_backward_reference(x, p, q, *params, dy, **kw)
    for name, got, leaf in zip(('x',) + PARAMS, plain, leaves):
        assert _rel_err(got, leaf.grad) <= 1e-5, name
    leaves2 = [t.clone().requires_grad_() for t in (x, *params)]
    before = (FB.launches, FB.bwd_launches)
    y = FB.bytenet_block(*leaves2, **kw)
    assert y.grad_fn is not None
    y.backward(dy)
    assert (FB.launches, FB.bwd_launches) == before
    for name, got, leaf in zip(('x',) + PARAMS, plain, leaves2):
        np.testing.assert_array_equal(leaf.grad.numpy(), got.numpy(), err_msg=name)
