"""The port's FLOP counts (hudiff_tpu_torch/utils/flops.py) against the JAX
package's.

- The kernel counters: ``block_matmul_flops`` and
  ``attention_matmul_flops`` equal JAX's; ``denoiser_kernel_flops`` of a
  forward equals JAX's ``denoiser_pallas_flops(deterministic=True,
  backward=False)`` at full width (Ab and Nb), where the two routings
  agree. A training pass differs by one documented term: JAX sends the Ab
  model's 768/384 dual towers to XLA on training traces
  (``conv_pallas_policy``), the port runs them through K2/K4, so the port's
  count is JAX's plus those blocks' ``block_matmul_flops(backward=True)``;
  the Nb model's 512/256 towers are fused in both.
- The whole-model count of a full-width Ab forward at B = 1 against XLA's
  ``cost_analysis()['flops']`` for JAX's ``AntiTFNet`` forward on the CPU
  (every stage through XLA): the port counts the matmuls (conv taps on the
  padding left out, as XLA leaves them out), XLA adds its elementwise
  operations; read 17.99 against 18.19 GFLOP, a ratio of 0.989, held within
  2%.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hudiff_tpu import constants as JC
from hudiff_tpu.models.denoiser import AntiTFNet as JNet
from hudiff_tpu.models.denoiser import DenoiserConfig as JCfg
from hudiff_tpu.models.denoiser import nano_config as j_nano_config
from hudiff_tpu.ops.pallas_attention import attention_matmul_flops as j_att_flops
from hudiff_tpu.ops.pallas_bytenet import block_matmul_flops as j_block_flops
from hudiff_tpu.training import train_step as JT
from hudiff_tpu.utils.flops import denoiser_pallas_flops
from hudiff_tpu_torch.models.denoiser import DenoiserConfig, nano_config
from hudiff_tpu_torch.ops.fused_attention import attention_matmul_flops
from hudiff_tpu_torch.ops.fused_bytenet import block_matmul_flops
from hudiff_tpu_torch.utils import flops as F

CONFIGS = {'pair': (DenoiserConfig(), JCfg()), 'heavy': (nano_config(), j_nano_config())}


@pytest.mark.parametrize('backward', [False, True])
def test_kernel_counters_equal_jax(backward):
    for shape in [(16, 152, 256, 128, 7), (128, 139, 768, 384, 7), (512, 152, 512, 256, 7)]:
        assert block_matmul_flops(*shape, backward=backward) == j_block_flops(
            *shape, backward=backward)
    for shape in [(16, 291, 8, 64), (128, 152, 4, 64), (1, 291, 2, 64)]:
        assert attention_matmul_flops(*shape, backward=backward) == j_att_flops(
            *shape, backward=backward)


@pytest.mark.parametrize('B', [1, 128])
@pytest.mark.parametrize('kind', ['pair', 'heavy'])
def test_forward_kernel_flops_equal_jax(kind, B):
    cfg, jcfg = CONFIGS[kind]
    want = denoiser_pallas_flops(jcfg, B, kind=kind, deterministic=True, backward=False)
    for deterministic in (True, False):   # the port's routing ignores it
        assert F.denoiser_kernel_flops(cfg, B, kind=kind, deterministic=deterministic,
                                       backward=False) == want


@pytest.mark.parametrize('kind', ['pair', 'heavy'])
def test_training_kernel_flops_are_jax_plus_the_dual_towers(kind):
    cfg, jcfg = CONFIGS[kind]
    B = 128
    jax_count = denoiser_pallas_flops(jcfg, B, kind=kind, deterministic=False, backward=True)
    got = F.denoiser_kernel_flops(cfg, B, kind=kind, deterministic=False, backward=True)
    if kind == 'heavy':   # the 512/256 nano_conv tower is fused in both
        assert got == jax_count
        return
    d = cfg.sum_d_model
    towers = sum(cfg.dual_layers * block_matmul_flops(B, L, d, d // 2, cfg.aa_kernel_size,
                                                      backward=True)
                 for L in (JC.HEAVY_LEN, JC.LIGHT_LEN))
    assert towers > 0 and got == jax_count + towers


def test_model_flops_within_two_percent_of_xla():
    jcfg = JCfg()
    args = (jnp.zeros((1, JC.PAIR_LEN), jnp.int32), jnp.asarray(JT.pair_region_batch(1)),
            jnp.zeros((1, 2), jnp.int32))
    model = JNet(jcfg, use_pallas='never')
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *args))
    cost = jax.jit(lambda p, *a: model.apply(p, *a)).lower(params, *args).compile()
    cost = cost.cost_analysis()
    xla = float((cost[0] if isinstance(cost, (list, tuple)) else cost)['flops'])
    ours = F.denoiser_model_flops(DenoiserConfig(), 1, kind='pair')
    ratio = ours / xla
    assert abs(ratio - 1) <= 0.02, (ours, xla, ratio)
    stages = F.denoiser_stage_flops(DenoiserConfig(), 1, kind='pair')
    assert sum(stages.values()) == ours


def test_backward_count_and_peak():
    cfg = DenoiserConfig()
    fwd = F.denoiser_model_flops(cfg, 4, kind='pair')
    both = F.denoiser_model_flops(cfg, 4, kind='pair', backward=True)
    core = F.denoiser_stage_flops(cfg, 4, kind='pair')['attention_core']
    att = 2 * cfg.cs_layers * attention_matmul_flops(4, cfg.max_len, cfg.nhead, 64,
                                                     backward=True)
    np.testing.assert_allclose(both, 3 * (fwd - core) + att, rtol=1e-12)
    assert F.H100_SXM_BF16_DENSE_TFLOPS == 989.4
    assert not F.kernels_active('cpu') and F.kernels_active('cuda')
    with pytest.raises(ValueError, match='unknown kind'):
        F.denoiser_kernel_flops(cfg, 1, kind='light')
