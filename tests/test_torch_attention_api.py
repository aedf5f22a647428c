"""Port K5, K6 and K7 (hudiff_tpu_torch/ops/fused_attention.py:
``rope_attention`` with its backward, ``fused_attention`` and
``attention``) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages. On the CPU
the port's wrappers run their plain versions; the JAX side runs its Pallas
kernels in interpret mode (``use_pallas='always'``, ``interpret=True``), as
tests/test_pallas_attention.py does, and differentiates through its custom
VJP (K6) with ``jax.vjp``.

Tolerances. f32: forward atol 2e-5 and gradients 3e-5, the limits of
tests/test_pallas_attention.py:45,70 (64-term products and an L-term
softmax in f32, summed in other orders). bf16: elementwise |out - ref| <=
2**-7 |ref| + atol: both sides round the output to bf16 and may round it
one spacing apart (the 2**-7 |ref| term); atol bounds the rest, which comes
from P (and, in the backward, dS) rounded to bf16 on either side of a
rounding boundary: 2e-3 (the largest reading here 6.1e-5, K5's forward; K6's
gradients and K7 stay within one spacing).

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
from hudiff_tpu_torch.ops import fused_attention as FA
from hudiff_tpu_torch.ops import rope as ROPE

H, D = 2, 64
BF16_RTOL = 2.0 ** -7
ATOL = {'f32': 2e-5, 'f32_grad': 3e-5, 'bf16': 2e-3, 'bf16_grad': 2e-3}
DTYPES = {'f32': (jnp.float32, torch.float32), 'bf16': (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist
    workers at once, and torch's default of a thread per core
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, *shapes):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _both(a, dt):
    """One numpy array as a JAX and a torch array of the same type."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _excess(out, ref, dt):
    """max |out - ref| for f32; max(|out - ref| - 2**-7 |ref|) for bf16."""
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    rtol = 0.0 if dt == 'f32' else BF16_RTOL
    return float((np.abs(out - ref) - rtol * np.abs(ref)).max())


def _np(t):
    return t.detach().float().numpy()


def _counters():
    return (FA.launches, FA.bwd_launches, FA.rope_launches, FA.rope_bwd_launches,
            FA.attention_launches)


def test_merge_qkv_heads_matches():
    q, k, v = _arrays(0, (2, 5, H * D), (2, 5, H * D), (2, 5, H * D))
    ref = JPA.merge_qkv_heads(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H)
    out = FA.merge_qkv_heads(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), H)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    back = FA.split_qkv_heads(out, H)
    for a, b in zip(back, (q, k, v)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('L', [17, 70])
def test_rope_attention_matches_pallas_interpret(L, dt):
    q, k, v = _arrays(L, *[(2, L, H * D)] * 3)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dt) for a in (q, k, v))
    cos_j, sin_j = JROPE.rope_tables(D, L)
    cos_t, sin_t = ROPE.rope_tables(D, L)
    scale = 1.0 / np.sqrt(D)
    ref = JPA.rope_attention(qj, kj, vj, cos_j, sin_j, scale, H, use_pallas='always')
    before = _counters()
    out = FA.rope_attention(qt, kt, vt, cos_t, sin_t, scale, H)
    assert _counters() == before   # CPU tensors never launch a kernel
    assert out.shape == (2, L, H * D) and out.dtype == DTYPES[dt][1]
    err = _excess(_np(out), ref, dt)
    assert err <= ATOL[dt], err


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
def test_rope_attention_grads_match_jax_vjp(dt):
    """K6: the gradients of ``jax.vjp`` through the Pallas custom VJP
    (interpret mode) against torch autograd through ``RopeAttention`` (K5
    forward, K6 backward; their plain versions on the CPU)."""
    B, L = 2, 23
    q, k, v, w = _arrays(7, *[(B, L, H * D)] * 4)
    (qj, qt), (kj, kt), (vj, vt), (wj, wt) = (_both(a, dt) for a in (q, k, v, w))
    cos_j, sin_j = JROPE.rope_tables(D, L)
    cos_t, sin_t = ROPE.rope_tables(D, L)
    scale = 1.0 / np.sqrt(D)
    _, vjp = jax.vjp(lambda a, b, c: JPA.rope_attention(a, b, c, cos_j, sin_j, scale, H,
                                                        use_pallas='always'), qj, kj, vj)
    ref = vjp(wj)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    before = _counters()
    out = FA.rope_attention(*leaves, cos_t, sin_t, scale, H)
    assert type(out.grad_fn).__name__ == 'RopeAttentionBackward'
    out.backward(wt)
    assert _counters() == before
    for name, leaf, want in zip('qkv', leaves, ref):
        assert leaf.grad.dtype == DTYPES[dt][1]
        err = _excess(_np(leaf.grad), want, dt)
        assert err <= ATOL[f'{dt}_grad'], (name, err)


def test_rope_attention_backward_reference_matches_autograd():
    """The plain K6 against torch autograd through the plain K5, and K3's
    plain version against K6's on the split qkv."""
    B, L = 2, 29
    q, k, v, do = (torch.from_numpy(a) for a in _arrays(3, *[(B, L, H * D)] * 4))
    cos, sin = ROPE.rope_tables(D, L)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    FA.rope_attention_reference(*leaves, cos, sin, 0.125, H).backward(do)
    plain = FA.rope_attention_backward_reference(q, k, v, cos, sin, do, 0.125, H)
    for got, leaf in zip(plain, leaves):
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), rtol=0, atol=1e-5)
    merged = FA.rope_attention_qkv_backward_reference(FA.merge_qkv_heads(q, k, v, H), cos,
                                                      sin, do, 0.125, H)
    np.testing.assert_array_equal(merged.numpy(), FA.merge_qkv_heads(*plain, H).numpy())


@pytest.mark.parametrize('dt', ['f32', 'bf16'])
@pytest.mark.parametrize('L', [19, 70])
def test_attention_matches_pallas_interpret(L, dt):
    """K7 through both of its entry points: ``attention`` on [B, L, H, D]
    against JAX's ``attention(..., use_pallas='always')`` and
    ``fused_attention`` on [B, H, L, D] against JAX's ``fused_attention``
    in interpret mode."""
    q, k, v = _arrays(L + 1, *[(2, L, H, D)] * 3)
    (qj, qt), (kj, kt), (vj, vt) = (_both(a, dt) for a in (q, k, v))
    scale = 1.0 / np.sqrt(D)
    before = _counters()
    ref = JPA.attention(qj, kj, vj, scale, use_pallas='always')
    out = FA.attention(qt, kt, vt, scale)
    assert out.shape == (2, L, H, D) and out.dtype == DTYPES[dt][1]
    assert _excess(_np(out), ref, dt) <= ATOL[dt]
    t = lambda x: x.transpose(0, 2, 1, 3)  # noqa: E731
    ref_bhld = JPA.fused_attention(t(qj), t(kj), t(vj), scale, interpret=True)
    out_bhld = FA.fused_attention(*(x.transpose(1, 2).contiguous() for x in (qt, kt, vt)),
                                  scale)
    assert out_bhld.shape == (2, H, L, D)
    assert _excess(_np(out_bhld), ref_bhld, dt) <= ATOL[dt]
    np.testing.assert_array_equal(_np(out_bhld), _np(out.transpose(1, 2)))
    assert _counters() == before


def test_attention_on_cpu_is_differentiable():
    """K7 has no backward; on the CPU its plain version is autograd's."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _arrays(4, *[(1, 9, H, D)] * 3))
    FA.attention(q, k, v, 0.125).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize('backward', [False, True])
def test_attention_matmul_flops_matches(backward):
    for B, L, heads, hd in ((1, 291, 8, 64), (64, 152, 4, 32)):
        assert FA.attention_matmul_flops(B, L, heads, hd, backward) == \
            JPA.attention_matmul_flops(B, L, heads, hd, backward)
