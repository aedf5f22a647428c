"""The port's one-call API (hudiff_tpu_torch/api.py) and its loading of the
released reference payloads, against the JAX package on the CPU.

- tests/test_api.py's four tests over a test-size port checkpoint, plus the
  refusal of an Orbax directory and the card as the default device.
- The released layouts (tests/test_release_payloads.py pins them: Ab
  pretraining, Ab fine-tune, Nb fine-tune with ``infilling_pretrain.``
  keys; configs pickled as ``easydict.EasyDict`` through the unpickle shim),
  built here with no reference checkout: a JAX random-init Flax tree goes
  through ``chip_smoke.reference_state_dict`` (port names -> reference
  names) and JAX's ``convert_torch_denoiser`` must give back the same tree;
  the port's ``load_denoiser`` on the payload must give JAX's logits within
  1e-4 (f32, test size) and the same ``finetuned``.
- ``load_abnativ`` reads a lightning ``.ckpt`` whose hparams are a pickled
  EasyDict, as ``convert_torch_abnativ`` does.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu import api as japi
from hudiff_tpu.models import abnativ as JA
from hudiff_tpu.models.denoiser import AntiTFNet as JAnti
from hudiff_tpu.models.denoiser import DenoiserConfig as JCfg
from hudiff_tpu.models.denoiser import NanoAntiTFNet as JNano
from hudiff_tpu.models.denoiser import nano_config as j_nano_config
from hudiff_tpu.sampling import humanize as JH
from hudiff_tpu.training import checkpoints as JCK
from hudiff_tpu_torch import api
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.models import abnativ as A
from hudiff_tpu_torch.models.denoiser import DenoiserConfig
from hudiff_tpu_torch.sampling import humanize as H
from hudiff_tpu_torch.training import checkpoints as CK
from hudiff_tpu_torch.training import finetune as FT

from chip_smoke import released_payload, released_scorer_payload, reference_state_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
REGION = np.concatenate([C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX])


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _init_tree(kind, seed):
    """(JAX config, a random-init Flax tree as numpy) at test size."""
    if kind == 'pair':
        cfg = JCfg().test_size()
        args = (jnp.zeros((1, C.PAIR_LEN), jnp.int32), jnp.asarray(REGION[None]),
                jnp.asarray([[0, 2]]))
        tree = JAnti(cfg).init(jax.random.PRNGKey(seed), *args)
    else:
        cfg = j_nano_config().test_size()
        tree = JNano(cfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, C.HEAVY_LEN), jnp.int32),
                               jnp.asarray(C.HEAVY_REGION_INDEX[None]))
    return cfg, jax.tree_util.tree_map(np.asarray, tree)


def _jax_logits(kind, cfg, tree, rs, B=3):
    if kind == 'pair':
        tokens = rs.randint(0, C.N_TOKENS, (B, C.PAIR_LEN))
        inputs = (tokens, np.tile(REGION, (B, 1)), np.asarray([[0, 1], [0, 2], [0, 1]]))
        return inputs, np.asarray(JAnti(cfg).apply(tree, *map(jnp.asarray, inputs)))
    tokens = rs.randint(0, C.N_TOKENS, (B, C.HEAVY_LEN))
    inputs = (tokens, np.tile(C.HEAVY_REGION_INDEX, (B, 1)))
    return inputs, np.asarray(JNano(cfg).apply(tree, *map(jnp.asarray, inputs)))


@pytest.fixture(scope='module')
def ab_ckpt(tmp_path_factory):
    """A test-size random-init Ab model as a port checkpoint."""
    cfg, tree = _init_tree('pair', 0)
    port_cfg = DenoiserConfig(**dataclasses.asdict(cfg))
    path = str(tmp_path_factory.mktemp('api_ckpt') / 'ab.pt')
    return CK.save(path, CK.from_flax_params(tree, port_cfg, device='cpu'), port_cfg)


# -- tests/test_api.py ----------------------------------------------------------------

def test_humanize_pair(ab_ckpt):
    cands = api.humanize_pair(H1, L1, ab_ckpt, n=2, batch_size=2, use_bf16=False,
                              device='cpu')
    assert len(cands) == 2 and len(set(cands)) == 2
    for h, l in cands:
        assert len(h) > 80 and len(l) > 70


def test_humanizer_cache_reused(ab_ckpt):
    api.humanize_pair(H1, L1, ab_ckpt, n=1, batch_size=2, use_bf16=False, device='cpu')
    before = dict(api._HUMANIZER_CACHE)
    api.humanize_pair(H1, L1, ab_ckpt, n=1, batch_size=2, use_bf16=False, device='cpu')
    assert dict(api._HUMANIZER_CACHE) == before  # same key, no reload
    assert all(key[-1] == 'cpu' for key in before)


def test_humanize_pair_rejects_garbage(ab_ckpt):
    with pytest.raises(ValueError):
        api.humanize_pair('AAAA', 'GGGG', ab_ckpt, batch_size=2, use_bf16=False,
                          device='cpu')


def test_graft_and_identity():
    h, l = api.graft(H1, L1)
    assert (h, l) == japi.graft(H1, L1)
    assert api.germline_identity(h, 'H') == pytest.approx(1.0)
    assert api.germline_identity(H1, 'H') == japi.germline_identity(H1, 'H') < 0.9


def test_orbax_dirs_are_refused_and_the_card_is_the_default(ab_ckpt):
    with pytest.raises(ValueError, match='Orbax'):
        api.humanize_pair(H1, L1, os.path.join(REPO, 'examples', 'demo_ab_tiny'),
                          device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            api.humanize_pair(H1, L1, ab_ckpt)
        with pytest.raises(RuntimeError, match='CUDA'):
            api.humanize_vhh(H1, ab_ckpt)


# -- the released payloads -------------------------------------------------------------

def _flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f'{prefix}{k}/'))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize('layout,kind,finetuned', [('ab_pretrain', 'pair', False),
                                                   ('ab_finetune', 'pair', True),
                                                   ('nb_finetune', 'heavy', True)])
def test_released_payload_loads_to_jax_logits(tmp_path, layout, kind, finetuned):
    cfg, tree = _init_tree(kind, 3)
    port_cfg = DenoiserConfig(**dataclasses.asdict(cfg))
    ref_sd = reference_state_dict(CK.flax_to_state_dict(tree, port_cfg), cfg.nhead)
    back = JCK.convert_torch_denoiser(ref_sd, pair=kind == 'pair', nhead=cfg.nhead)
    want, got = _flat(tree), _flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's converter is JAX's
    port_back = _flat(CK.convert_torch_denoiser(ref_sd, pair=kind == 'pair', nhead=cfg.nhead))
    assert sorted(port_back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(port_back[k], want[k], err_msg=k)

    path = str(tmp_path / f'{layout}.pt')
    torch.save(released_payload(layout, ref_sd, dataclasses.asdict(cfg)), path)
    with pytest.raises(Exception):   # pickled EasyDicts: not plain data
        torch.load(path, weights_only=True)
    model, found = H.load_denoiser(path, kind, device='cpu', use_bf16=False)
    assert found is finetuned
    assert JH.load_denoiser(path, kind, use_bf16=False)[2] is finetuned
    inputs, ref = _jax_logits(kind, cfg, tree, np.random.RandomState(4))
    with torch.no_grad():
        out = model(*(torch.from_numpy(np.asarray(a)).long() for a in inputs)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_humanize_cli_and_api_from_a_released_payload(tmp_path):
    cfg, tree = _init_tree('pair', 5)
    port_cfg = DenoiserConfig(**dataclasses.asdict(cfg))
    ref_sd = reference_state_dict(CK.flax_to_state_dict(tree, port_cfg), cfg.nhead)
    path = str(tmp_path / 'hudiffab.pt')
    torch.save(released_payload('ab_pretrain', ref_sd, dataclasses.asdict(cfg)), path)
    out = H.main(['ab', '--ckpt', path, '--hseq', H1, '--lseq', L1, '--batch-size', '2',
                  '--device', 'cpu', '--fp32', '--logdir', str(tmp_path / 'logs')])
    with open(out) as f:
        lines = f.read().splitlines()
    assert lines[1].startswith('mouse,input,') and lines[2].startswith('humanization,')
    cands = api.humanize_pair(H1, L1, path, batch_size=2, use_bf16=False, device='cpu')
    assert len(cands) == 1


def test_load_abnativ_reads_a_lightning_ckpt_with_pickled_hparams(tmp_path):
    hp_kw = dict(d_embedding=32, kernel=4, stride=2, num_heads=2, num_mha_layers=1, d_ff=64,
                 num_embeddings=16, embedding_dim_code_book=8)
    jm = JA.AbNatiVModel(JA.AbNatiVParams(**hp_kw))
    variables = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(6), jnp.zeros((1, C.AHO_LEN, 21))))
    hp = A.AbNatiVParams(**hp_kw)
    src = A.AbNatiVModel(hp)
    src.load_state_dict(A.flax_to_state_dict(variables, hp))
    path = str(tmp_path / 'VH_model.ckpt')
    torch.save(released_scorer_payload(src), path)
    with pytest.raises(Exception):   # the hparams are a pickled EasyDict
        torch.load(path, weights_only=True)
    model = FT.load_abnativ(path, straight_through=False, device='cpu')
    conv = JA.convert_torch_abnativ(JCK.load_torch_checkpoint(path))
    assert dataclasses.asdict(model.hp) == dataclasses.asdict(conv['hp'])
    rs = np.random.RandomState(7)
    x = np.eye(21, dtype=np.float32)[rs.randint(0, 21, (3, C.AHO_LEN))]
    want = JA.AbNatiVModel(conv['hp']).apply(conv['variables'], jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for k in ('x_recon', 'recon_error_pposi'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5)
    # a file the port wrote (plain data) keeps loading
    plain = FT.save_abnativ(str(tmp_path / 'plain.ckpt'), model)
    again = FT.load_abnativ(plain, straight_through=False, device='cpu')
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k
