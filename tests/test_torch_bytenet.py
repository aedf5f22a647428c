"""Port K2 (hudiff_tpu_torch/ops/fused_bytenet.py) and the ByteNet modules
against the JAX package.

Parameters and inputs are made with numpy from a seed; the JAX
``ByteNetBlock`` runs both its Pallas kernel in interpret mode
(``use_pallas='always'``, as tests/test_pallas_bytenet.py does) and its
Flax module path (``'never'``). The port's block runs its plain version on
the CPU. f32; tolerance atol 1e-5 (three LayerNorms and three f32
contractions of <= 7*48 terms, summed in other orders).

The CUDA kernels are held against the plain version on a card in
tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hudiff_tpu.ops.bytenet import ByteNetBlock as JBlock
from hudiff_tpu.ops.bytenet import ByteNetStack as JStack
from hudiff_tpu.ops.bytenet import dilation_schedule as j_dilation_schedule
from hudiff_tpu_torch.ops import bytenet as BN

# f32 is compared: no TF32 in matmuls or convolutions (a card would use it)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

D_MODEL, D_H, K = 32, 16, 7


def _rand_block_params(rs, d, h, k):
    """A Flax ByteNetBlock param tree with non-trivial LN and bias values."""
    n = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    ln = lambda m: {'scale': 1 + 0.1 * n(m), 'bias': 0.1 * n(m)}  # noqa: E731
    return {'LayerNorm_0': ln(d), 'Dense_0': {'kernel': n(d, h) / d ** 0.5, 'bias': 0.1 * n(h)},
            'LayerNorm_1': ln(h),
            'DilatedConv1d_0': {'Conv_0': {'kernel': n(k, h, h) / (k * h) ** 0.5,
                                           'bias': 0.1 * n(h)}},
            'LayerNorm_2': ln(h), 'Dense_1': {'kernel': n(h, d) / h ** 0.5, 'bias': 0.1 * n(d)}}


def _load_block(block: BN.ByteNetBlock, p) -> None:
    sd = {}
    for src, dst in (('LayerNorm_0', 'ln1'), ('LayerNorm_1', 'ln2'), ('LayerNorm_2', 'ln3')):
        sd[f'{dst}.weight'], sd[f'{dst}.bias'] = p[src]['scale'], p[src]['bias']
    for src, dst in (('Dense_0', 'fc1'), ('Dense_1', 'fc2')):
        sd[f'{dst}.weight'], sd[f'{dst}.bias'] = p[src]['kernel'].T, p[src]['bias']
    conv = p['DilatedConv1d_0']['Conv_0']
    sd['conv.weight'], sd['conv.bias'] = conv['kernel'].transpose(2, 0, 1), conv['bias']
    block.load_state_dict({k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()})


def test_dilation_schedule_matches():
    for n, r in ((6, 128), (6, 32), (13, 8)):
        assert BN.dilation_schedule(n, r) == list(j_dilation_schedule(n, r))


@pytest.mark.parametrize('L', [139, 152])
@pytest.mark.parametrize('dil', [1, 4, 32])
@pytest.mark.parametrize('act', ['relu', 'gelu'])
def test_block_matches_jax(act, dil, L):
    rs = np.random.RandomState(dil * 1000 + L)
    p = _rand_block_params(rs, D_MODEL, D_H, K)
    x = rs.randn(2, L, D_MODEL).astype(np.float32)
    port = BN.ByteNetBlock(D_MODEL, D_H, K, dilation=dil, activation=act)
    _load_block(port, p)
    with torch.no_grad():
        out = port(torch.from_numpy(x)).numpy()
    for use_pallas in ('always', 'never'):
        ref = np.asarray(JBlock(D_H, D_MODEL, K, dilation=dil, activation=act,
                                use_pallas=use_pallas).apply({'params': p}, jnp.asarray(x)))
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5, err_msg=use_pallas)


def test_stack_matches_jax_and_dropout_only_in_training():
    rs = np.random.RandomState(3)
    n_layers, r = 3, 4
    jstack = JStack(n_layers, D_MODEL, K, r, activation='gelu', dropout=0.2)
    params = {f'ByteNetBlock_{i}': _rand_block_params(rs, D_MODEL, D_H, K)
              for i in range(n_layers)}
    x = rs.randn(2, 40, D_MODEL).astype(np.float32)
    ref = np.asarray(jstack.apply({'params': params}, jnp.asarray(x)))
    port = BN.ByteNetStack(n_layers, D_MODEL, K, r, activation='gelu', dropout=0.2)
    assert [b.dilation for b in port.blocks] == [1, 2, 4]
    for i, block in enumerate(port.blocks):
        _load_block(block, params[f'ByteNetBlock_{i}'])
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(port.eval()(xt).numpy(), ref, rtol=0, atol=1e-5)
        torch.manual_seed(0)
        assert not torch.allclose(port.train()(xt), port.eval()(xt))
