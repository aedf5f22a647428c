"""Port embedders and ``AntiTFNet`` (hudiff_tpu_torch/models/) against the
JAX package, with weights carried across by
``hudiff_tpu_torch.training.checkpoints.from_flax_params``.

Weights are drawn with numpy from a seed into the Flax parameter tree's
shapes (or restored from the in-repo demo checkpoint) and fed to both
packages; inputs likewise. Both run f32 on the CPU, the port through the
plain versions of its kernels. Tolerance on logits: atol 1e-4 (logits are
O(1-10); the two packages sum the same f32 terms in different orders
through up to 24 ByteNet blocks and 10 attentions).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu import constants as C
from hudiff_tpu.models import embedders as JE
from hudiff_tpu.models.denoiser import AntiTFNet as JNet
from hudiff_tpu.models.denoiser import DenoiserConfig as JCfg
from hudiff_tpu_torch.models import embedders as E
from hudiff_tpu_torch.models.denoiser import DenoiserConfig
from hudiff_tpu_torch.sampling import sampler as S
from hudiff_tpu_torch.training import checkpoints as CK

# f32 is compared: no TF32 in matmuls or convolutions (a card would use it)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist workers
    at once, and torch's default of a thread per core oversubscribes the
    cores, which slows these many small ops several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, seed):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, C.N_TOKENS, (B, C.PAIR_LEN)).astype(np.int32)
    region = np.tile(np.concatenate([C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]),
                     (B, 1)).astype(np.int32)
    chain = np.stack([np.zeros(B), rs.randint(1, 3, B)], 1).astype(np.int32)
    return tokens, region, chain


def _random_tree(jcfg, seed):
    """Numpy weights in the shapes of ``AntiTFNet(jcfg).init``'s tree."""
    shapes = jax.eval_shape(JNet(jcfg).init, jax.random.PRNGKey(0), *_inputs(1, 0))
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == 'scale':
            v = 1 + 0.1 * rs.randn(*s.shape)
        elif name == 'bias':
            v = 0.1 * rs.randn(*s.shape)
        elif name == 'embedding':
            v = rs.randn(*s.shape)
        else:  # kernel: [in, out] or [K, in, out]
            v = rs.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _torch(*arrays):
    return [torch.from_numpy(a).long() for a in arrays]


def _port_logits(model, tokens, region, chain):
    with torch.no_grad():
        return model(*_torch(tokens, region, chain)).numpy()


def _check_parity(jcfg, tree, B, seed):
    tokens, region, chain = _inputs(B, seed)
    ref = np.asarray(JNet(jcfg).apply(tree, tokens, region, chain))
    model = CK.from_flax_params(tree, DenoiserConfig(**jcfg.__dict__), device='cpu')
    out = _port_logits(model, tokens, region, chain)
    assert out.shape == (B, C.PAIR_LEN, C.N_TOKENS) and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)
    return model, out


@pytest.fixture(scope='module')
def small():
    jcfg = JCfg().test_size()
    return jcfg, _random_tree(jcfg, 1)


def test_sinusoidal_table_matches():
    np.testing.assert_array_equal(E.sinusoidal_table(64, 291),
                                  JE.sinusoidal_table(64, 291))


@pytest.mark.parametrize('which', ['side', 'region', 'pos'])
def test_embedders_match(small, which):
    jcfg, tree = small
    p = tree['params']
    model = CK.from_flax_params(tree, DenoiserConfig(**jcfg.__dict__), device='cpu')
    tokens, region, chain = _inputs(3, 4)
    if which == 'side':
        ref = JE.SideEmbedder(jcfg.n_side, jcfg.s_embedding, jcfg.s_model, C.HEAVY_LEN,
                              C.LIGHT_LEN).apply({'params': p['side_encoder']}, chain)
        with torch.no_grad():
            out = model.side_encoder(torch.from_numpy(chain).long())
    elif which == 'region':
        ref = JE.RegionEmbedder(jcfg.n_region, jcfg.r_embedding, jcfg.r_model).apply(
            {'params': p['region_encoder']}, region)
        with torch.no_grad():
            out = model.region_encoder(torch.from_numpy(region).long())
    else:
        x = np.random.RandomState(5).randn(3, C.PAIR_LEN, jcfg.n_pos_model).astype(np.float32)
        ref = JE.PosEmbedder(jcfg.n_pos_model, jcfg.max_len).apply(
            {'params': p['pos_encoder']}, jnp.asarray(x))
        with torch.no_grad():
            out = model.pos_encoder(torch.from_numpy(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_antitfnet_matches_test_size(small):
    jcfg, tree = small
    _check_parity(jcfg, tree, B=3, seed=7)


def test_antitfnet_matches_full_width():
    """The default config (configs/antibody_train.yml): aa towers 256/128,
    dual towers 768/384, 5 attention blocks of 8 x 64, L = 291."""
    jcfg = JCfg()
    _check_parity(jcfg, _random_tree(jcfg, 2), B=1, seed=8)


def test_antitfnet_matches_demo_checkpoint():
    from hudiff_tpu.training.checkpoints import restore
    restored = restore(os.path.join(REPO, 'examples', 'demo_ab_tiny'))
    jcfg = JCfg.from_dict(restored['meta']['config']['model'])
    tree = jax.tree_util.tree_map(np.asarray, restored['payload']['params'])
    tree = tree if 'params' in tree else {'params': tree}
    _check_parity(jcfg, tree, B=2, seed=9)


def test_port_checkpoint_roundtrip(small, tmp_path):
    jcfg, tree = small
    cfg = DenoiserConfig(**jcfg.__dict__)
    model = CK.from_flax_params(tree, cfg, device='cpu')
    path = CK.save(str(tmp_path / 'ab.pt'), model, cfg, finetuned=True)
    loaded, config = CK.load(path, device='cpu')
    assert config['finetuned'] is True and DenoiserConfig.from_dict(config['model']) == cfg
    args = _inputs(2, 10)
    np.testing.assert_array_equal(_port_logits(loaded, *args), _port_logits(model, *args))


def test_bf16_cast_once(small):
    """Cast-once rounds every >=2-D parameter (embedding tables and the
    decoder weight included) to bf16 and keeps LayerNorm parameters and
    biases f32; the decoder still returns f32 logits. Held against the JAX
    model computing in bf16 with the same cast: both round activations to
    bf16 at slightly different points. Each lies ~0.03 from the f32 logits
    (O(4) here), so atol 0.1."""
    jcfg, tree = small
    model = CK.from_flax_params(tree, DenoiserConfig(**jcfg.__dict__), dtype=torch.bfloat16,
                                 device='cpu')
    S.cast_params_once(model)
    for name, prm in model.named_parameters():
        assert prm.dtype == (torch.bfloat16 if prm.dim() >= 2 else torch.float32), name
    assert model.decoder.weight.dtype == model.aa_embed.weight.dtype == torch.bfloat16
    args = _inputs(2, 11)
    out = _port_logits(model, *args)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    cast = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.bfloat16) if x.ndim >= 2 else x, tree)
    ref = np.asarray(JNet(jcfg, dtype=jnp.bfloat16).apply(cast, *args))
    np.testing.assert_allclose(out, ref, rtol=0, atol=0.1)
