"""Port K1 (hudiff_tpu_torch/ops/fused_attention.py) against the JAX package.

Inputs are made with numpy from a seed and fed to both packages. On the CPU
the port's ``rope_attention_qkv`` runs its plain version; the JAX side runs
its Pallas kernel in interpret mode (``use_pallas='always'``), as
tests/test_pallas_attention.py does. f32 throughout; tolerance atol 1e-5
(both sides accumulate 64-term dot products and a <=291-term softmax in
f32, in different orders).

The CUDA kernel is held against the plain version on a card in
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hudiff_tpu.ops import pallas_attention as JPA
from hudiff_tpu.ops import rope as JROPE
from hudiff_tpu_torch.ops import fused_attention as FA
from hudiff_tpu_torch.ops import rope as ROPE

# f32 is compared: no TF32 in matmuls or convolutions (a card would use it)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

H, D = 8, 64


def _qkv(B, L, seed):
    return np.random.RandomState(seed).randn(B, L, H * 3 * D).astype(np.float32)


def test_rope_tables_match():
    cos_j, sin_j = JROPE.rope_tables(D, 291)
    cos_t, sin_t = ROPE.rope_tables(D, 291)
    np.testing.assert_array_equal(cos_t.numpy(), np.asarray(cos_j))
    np.testing.assert_array_equal(sin_t.numpy(), np.asarray(sin_j))


def test_apply_rope_matches():
    x = np.random.RandomState(1).randn(2, 37, H, D).astype(np.float32)
    cos_j, sin_j = JROPE.rope_tables(D, 37)
    cos_t, sin_t = ROPE.rope_tables(D, 37)
    ref = np.asarray(JROPE.apply_rope(jnp.asarray(x), cos_j, sin_j))
    out = ROPE.apply_rope(torch.from_numpy(x), cos_t, sin_t).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_split_qkv_heads_matches():
    qkv = _qkv(2, 5, 2)
    for got, ref in zip(FA.split_qkv_heads(torch.from_numpy(qkv), H),
                        JPA.split_qkv_heads(jnp.asarray(qkv), H)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize('L', [17, 291])
def test_rope_attention_qkv_matches_pallas_interpret(L):
    B = 2
    qkv = _qkv(B, L, L)
    cos_j, sin_j = JROPE.rope_tables(D, L)
    cos_t, sin_t = ROPE.rope_tables(D, L)
    scale = 1.0 / np.sqrt(D)
    ref = np.asarray(JPA.rope_attention_qkv(jnp.asarray(qkv), cos_j, sin_j, scale,
                                            H, use_pallas='always'))
    before = FA.launches
    out = FA.rope_attention_qkv(torch.from_numpy(qkv), cos_t, sin_t, scale, H)
    assert FA.launches == before  # CPU tensors never launch the kernel
    assert out.shape == (B, L, H * D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
