"""The attention backward's residuals (hudiff_tpu_torch/ops/fused_attention.py).

K3 and K6 on the card work from two residuals of the forward, which K1 and
K5 write when asked: ``out_f32``, P v with P in f32 (the output before
rounding), and ``lse`` [B, H, L] f32, the scaled scores' row log-sum-exp.
Their plain versions here: ``rope_attention_reference(..., residuals=True)``
and ``rope_attention_backward_reference(..., out, lse)``, the backward in
the kernels' arithmetic: P = exp(S - lse), delta = rowsum(dO * out_f32).
They are held against the JAX package's Pallas backward kernels
``_pallas_bwd`` (K6) and ``_pallas_bwd_qkv`` (K3) in interpret mode, which
recompute the softmax and take delta = rowsum(dP * P), as
tests/test_torch_backward.py holds the plain version without residuals.

Inputs come from a numpy seed; B = 2, H = 2, L in {37, 100, 291} (291
leaves a ragged last 64-row tile: 35 of 64 rows). Tolerances. f32:
elementwise 1e-5 (64-term products and L-term softmax sums in other
orders; exp(S - lse) against the normalised softmax moves P by f32 ulps).
bf16: elementwise |out - ref| <= 2**-7 |ref| + 5e-3, the card's gate for K3
and K6 (chip_smoke.py TOL_BF16): both sides round the gradient to bf16 (the
2**-7 |ref| term); the rest comes from dS rounded to bf16 on either side of
a rounding boundary, where P from lse and delta from out_f32 move it by
f32 ulps (largest reading on the CPU 6.2e-4, K6's dk at L = 100).
``test_delta_needs_the_unrounded_output`` keeps the finding behind
out_f32: delta from the bf16 output moves the same gradients by 4.1e-3.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu.ops import pallas_attention as JPA
from hudiff_tpu.ops import rope as JROPE
from hudiff_tpu_torch.ops import fused_attention as FA
from hudiff_tpu_torch.ops import rope as ROPE

H, D = 2, 64
BF16_RTOL = 2.0 ** -7
ATOL = {'f32': 1e-5, 'bf16': 5e-3}
DTYPES = {'f32': (jnp.float32, torch.float32), 'bf16': (jnp.bfloat16, torch.bfloat16)}
LENGTHS = [37, 100, 291]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist
    workers at once, and torch's default of a thread per core
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, n, L):
    rs = np.random.RandomState(seed)
    return [rs.randn(2, L, H * D).astype(np.float32) for _ in range(n)]


def _excess(out, ref, dt):
    """max |out - ref| for f32; max(|out - ref| - 2**-7 |ref|) for bf16."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    rtol = 0.0 if dt == 'f32' else BF16_RTOL
    return float((np.abs(out - ref) - rtol * np.abs(ref)).max())


def _np(t):
    return t.detach().float().numpy()


def _tables(L):
    """The port's [L, 32] tables and the Pallas kernels' [L, 64] ones
    (both halves), as pallas_attention.py:355-356 builds them."""
    cos_t, sin_t = ROPE.rope_tables(D, L)
    cos_j, sin_j = JROPE.rope_tables(D, L)
    return (cos_t, sin_t), (jnp.concatenate([cos_j, cos_j], axis=1).astype(jnp.float32),
                            jnp.concatenate([sin_j, sin_j], axis=1).astype(jnp.float32))


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('L', LENGTHS)
def test_forward_with_residuals(L, dt):
    """The plain forward gives the same output with and without residuals;
    lse is the scores' row log-sum-exp and out_f32 is P v (both against
    float64 from the same rotated, rounded q and k: 1e-5); the merged qkv
    form gives the same bits."""
    tdt = DTYPES[dt][1]
    q, k, v = (torch.from_numpy(a).to(tdt) for a in _arrays(L, 3, L))
    (cos, sin), _ = _tables(L)
    scale = 1.0 / np.sqrt(D)
    out, out_f32, lse = FA.rope_attention_reference(q, k, v, cos, sin, scale, H,
                                                    residuals=True)
    assert torch.equal(out, FA.rope_attention_reference(q, k, v, cos, sin, scale, H))
    assert lse.shape == (2, H, L) and lse.dtype == torch.float32
    assert out_f32.shape == out.shape and out_f32.dtype == torch.float32
    qh = ROPE.apply_rope(q.reshape(2, L, H, D), cos, sin).double()
    kh = ROPE.apply_rope(k.reshape(2, L, H, D), cos, sin).double()
    logits = torch.einsum('blhd,bmhd->bhlm', qh, kh) * scale
    assert (lse.double() - torch.logsumexp(logits, dim=-1)).abs().max().item() <= 1e-5
    want = torch.einsum('bhlm,bmhd->blhd', torch.softmax(logits, dim=-1),
                        v.double().reshape(2, L, H, D)).reshape(2, L, H * D)
    assert (out_f32.double() - want).abs().max().item() <= 1e-5
    merged = FA.rope_attention_qkv_reference(FA.merge_qkv_heads(q, k, v, H), cos, sin, scale,
                                             H, residuals=True)
    assert all(torch.equal(a, b) for a, b in zip(merged, (out, out_f32, lse)))


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('L', LENGTHS)
def test_k6_from_residuals_matches_pallas_interpret(L, dt):
    jdt, tdt = DTYPES[dt]
    q, k, v, do = _arrays(L + 1, 4, L)
    (cos_t, sin_t), (cf, sf) = _tables(L)
    scale = 1.0 / np.sqrt(D)
    ref = JPA._pallas_bwd(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), cf, sf,
                          jnp.asarray(do).astype(jdt), scale, H, True)
    qt, kt, vt, dot = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    _, out, lse = FA.rope_attention_reference(qt, kt, vt, cos_t, sin_t, scale, H, True)
    got = FA.rope_attention_backward_reference(qt, kt, vt, cos_t, sin_t, dot, scale, H, out,
                                               lse)
    for name, g, want in zip('qkv', got, ref):
        assert g.shape == (2, L, H * D) and g.dtype == tdt
        err = _excess(_np(g), want, dt)
        assert err <= ATOL[dt], (name, err)


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('L', LENGTHS)
def test_k3_from_residuals_matches_pallas_interpret(L, dt):
    jdt, tdt = DTYPES[dt]
    rs = np.random.RandomState(L + 2)
    qkv = rs.randn(2, L, 3 * H * D).astype(np.float32)
    do = rs.randn(2, L, H * D).astype(np.float32)
    (cos_t, sin_t), (cf, sf) = _tables(L)
    scale = 1.0 / np.sqrt(D)
    ref = JPA._pallas_bwd_qkv(jnp.asarray(qkv).astype(jdt), cf, sf,
                              jnp.asarray(do).astype(jdt), scale, H, True)
    qkv_t, do_t = torch.from_numpy(qkv).to(tdt), torch.from_numpy(do).to(tdt)
    _, out, lse = FA.rope_attention_qkv_reference(qkv_t, cos_t, sin_t, scale, H, True)
    got = FA.rope_attention_qkv_backward_reference(qkv_t, cos_t, sin_t, do_t, scale, H, out,
                                                   lse)
    assert got.shape == qkv.shape and got.dtype == tdt
    err = _excess(_np(got), ref, dt)
    assert err <= ATOL[dt], err


def test_delta_needs_the_unrounded_output():
    """The finding behind out_f32, in bf16 at L = 37 (K3): delta =
    rowsum(dO * out) over the bf16 output moves dq and dk beyond 4e-3 past
    one bf16 spacing of the Pallas kernel's gradients (80% of the card's
    5e-3), while delta over out_f32 stays within 1e-4."""
    L = 37
    rs = np.random.RandomState(L + 2)
    qkv = rs.randn(2, L, 3 * H * D).astype(np.float32)
    do = rs.randn(2, L, H * D).astype(np.float32)
    (cos, sin), (cf, sf) = _tables(L)
    ref = JPA._pallas_bwd_qkv(jnp.asarray(qkv).astype(jnp.bfloat16), cf, sf,
                              jnp.asarray(do).astype(jnp.bfloat16), 0.125, H, True)
    qkv_t, do_t = (torch.from_numpy(a).to(torch.bfloat16) for a in (qkv, do))
    out, out_f32, lse = FA.rope_attention_qkv_reference(qkv_t, cos, sin, 0.125, H, True)
    unrounded, rounded = (FA.rope_attention_qkv_backward_reference(
        qkv_t, cos, sin, do_t, 0.125, H, o, lse) for o in (out_f32, out.float()))
    assert _excess(_np(unrounded), ref, 'bf16') <= 1e-4
    assert _excess(_np(rounded), ref, 'bf16') > 4e-3


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_autograd_functions_with_and_without_saved_residuals(dt):
    """On CPU tensors ``RopeAttention`` and ``RopeAttentionQKV`` save the
    residuals beside their inputs and give exactly the gradients of the
    backward called with and without them, launching nothing; the kernels'
    arithmetic from the residuals lies within the tolerance of them."""
    tdt = DTYPES[dt][1]
    L = 41
    q, k, v, do = (torch.from_numpy(a).to(tdt) for a in _arrays(5, 4, L))
    (cos, sin), _ = _tables(L)
    counters = (FA.launches, FA.bwd_launches, FA.rope_launches, FA.rope_bwd_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FA.rope_attention(*leaves, cos, sin, 0.125, H)
    _, out_f32, lse = FA.rope_attention_forward(q, k, v, cos, sin, 0.125, H, residuals=True)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5 and torch.equal(saved[3], out_f32) and torch.equal(saved[4], lse)
    out.backward(do)
    plain = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, H)
    given = FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, H, out=out_f32, lse=lse)
    residual = FA.rope_attention_backward_reference(q, k, v, cos, sin, do, 0.125, H, out_f32,
                                                    lse)
    for leaf, want, same, res in zip(leaves, plain, given, residual):
        assert torch.equal(leaf.grad, want) and torch.equal(same, want)
        assert _excess(_np(res), _np(want), dt) <= ATOL[dt]
    qkv = FA.merge_qkv_heads(q, k, v, H)
    leaf = qkv.clone().requires_grad_()
    out = FA.rope_attention_qkv(leaf, cos, sin, 0.125, H)
    assert len(out.grad_fn.saved_tensors) == 3
    out.backward(do)
    assert torch.equal(leaf.grad, FA.rope_attention_qkv_backward(qkv, cos, sin, do, 0.125, H))
    assert torch.equal(leaf.grad, FA.merge_qkv_heads(*plain, H))
    assert (FA.launches, FA.bwd_launches, FA.rope_launches, FA.rope_bwd_launches) == counters
    with pytest.raises(ValueError, match='both out and lse'):
        FA.rope_attention_backward(q, k, v, cos, sin, do, 0.125, H, lse=lse)
