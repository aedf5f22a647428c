"""The port's AbNatiV scorer (hudiff_tpu_torch/models/abnativ.py) against
the JAX package's (hudiff_tpu/models/abnativ.py), on the CPU.

- The padding math of both, and the decoder's crop at the released
  hparams (L = 149, K = 4, S = 2: l_red 74, padding 1, a 150-row VALID
  transpose cropped to 149 rows).
- The forward at the smoke hparams and at ``AbNatiVParams()`` (B = 2),
  straight-through on and off, on the same Flax weights carried across by
  ``flax_to_state_dict``: every output to 1e-5, the codebook indices
  equal, and the gradient with respect to the inputs to 1e-5 of max |ref|.
- Both score functions to 1e-6, and the empty selection: 1.0 in both, a
  NaN gradient in JAX and a zero one in the port.
- The weight carry-across: port state_dict -> JAX ``convert_torch_abnativ``
  -> the same Flax tree, bit for bit; ``load_abnativ`` of a reference-layout
  file written here.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu.models import abnativ as JA
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.models import abnativ as A
from hudiff_tpu_torch.training import finetune as FTT

SMOKE = dict(d_embedding=32, kernel=4, stride=2, num_heads=2, num_mha_layers=1, d_ff=64,
             num_embeddings=16, embedding_dim_code_book=8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (several xdist workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _onehot(B, seed, gaps=0.3):
    """[B, 149, 21] one-hots: residues, with a share of gap columns."""
    rs = np.random.RandomState(seed)
    idx = rs.randint(0, 20, (B, C.AHO_LEN))
    idx[rs.rand(B, C.AHO_LEN) < gaps] = C.ABNATIV_GAP_IDX
    out = np.zeros((B, C.AHO_LEN, C.ABNATIV_ALPHABET_SIZE), np.float32)
    out[np.arange(B)[:, None], np.arange(C.AHO_LEN)[None], idx] = 1.0
    return out


def _pair(hp_kw, straight_through, seed=0):
    """(JAX model, its variables as numpy, the port model on the same weights)."""
    jhp = JA.AbNatiVParams(**hp_kw)
    jm = JA.AbNatiVModel(jhp, straight_through=straight_through)
    variables = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, C.AHO_LEN, 21)))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    hp = A.AbNatiVParams(**hp_kw)
    model = A.AbNatiVModel(hp, straight_through=straight_through)
    model.load_state_dict(A.flax_to_state_dict(variables, hp))
    return jm, variables, A.frozen(model)


def test_padding_math_matches_jax():
    for L, K, S in [(149, 4, 2), (149, 7, 3), (149, 5, 2), (149, 9, 4), (100, 4, 2)]:
        got = A.find_optimal_cnn1d_padding(L, K, S)
        assert got == JA.find_optimal_cnn1d_padding(L, K, S)
        assert (A.find_out_padding_cnn1d_transpose(L, got[0], K, S, got[1])
                == JA.find_out_padding_cnn1d_transpose(L, got[0], K, S, got[1]))
    assert A.find_optimal_cnn1d_padding(149, 4, 2) == (74, 1)
    hp = A.AbNatiVParams()
    dec = A.AbNatiVDecoder(hp)
    z = dec.cnn_reconstruction(torch.zeros(1, 74, hp.d_embedding))
    assert z.shape[1] == 150 and dec.padding == 1   # [1:150] is 149 rows, no zero pad
    assert dec(torch.zeros(1, 74, hp.d_embedding)).shape == (1, 149, 21)
    with pytest.raises(ValueError):
        A.find_optimal_cnn1d_padding(3, 4, 2)


OUT_KEYS = ('x_recon', 'recon_error_pres_pposi', 'recon_error_pposi', 'recon_error_pbe',
            'loss_pbe', 'loss_vq_commit_pbe', 'quantize_projected_out', 'perplexity')


@pytest.mark.parametrize('straight_through', [False, True])
@pytest.mark.parametrize('hp_kw', [SMOKE, {}], ids=['smoke', 'released'])
def test_forward_and_input_gradient_match_jax(hp_kw, straight_through):
    jm, variables, model = _pair(hp_kw, straight_through)
    x = _onehot(2, 3)
    portion = (np.random.RandomState(4).rand(2, C.AHO_LEN) < 0.4).astype(np.float32)

    def j_objective(x):
        out = jm.apply(variables, x)
        return (JA.nativeness_scores(out, portion, 'VH').sum() + out['loss_pbe'].sum(), out)

    (_, ref), ref_grad = jax.value_and_grad(j_objective, has_aux=True)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = model(xt)
    (A.nativeness_scores(out, torch.from_numpy(portion), 'VH').sum()
     + out['loss_pbe'].sum()).backward()
    for k in OUT_KEYS:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(out['encoding_indices'].numpy(),
                                  np.asarray(ref['encoding_indices']))
    g, r = xt.grad.numpy(), np.asarray(ref_grad)
    assert np.abs(r).max() > 0
    assert np.abs(g - r).max() <= 1e-5 * np.abs(r).max()


@pytest.mark.parametrize('model_type', ['VH', 'VKappa', 'VLambda', 'VHH'])
def test_score_functions_match_jax(model_type):
    rs = np.random.RandomState(5)
    err = (0.05 * rs.rand(3, C.AHO_LEN)).astype(np.float32)
    portion = rs.rand(3, C.AHO_LEN) < 0.3
    x = _onehot(3, 6)
    out_t = {'recon_error_pposi': torch.from_numpy(err), 'inputs': torch.from_numpy(x)}
    out_j = {'recon_error_pposi': jnp.asarray(err), 'inputs': jnp.asarray(x)}
    for all_seq in (False, True):
        np.testing.assert_allclose(
            A.nativeness_scores(out_t, torch.from_numpy(portion), model_type, all_seq).numpy(),
            np.asarray(JA.nativeness_scores(out_j, portion, model_type, all_seq)),
            rtol=0, atol=1e-6)
    np.testing.assert_allclose(A.nativeness_scores_seq(out_t, model_type).numpy(),
                               np.asarray(JA.nativeness_scores_seq(out_j, model_type)),
                               rtol=0, atol=1e-6)


def test_empty_selection_scores_one_with_a_zero_gradient():
    """A row with no selected position scores 1.0 in both packages; the JAX
    gradient of that row is NaN (0/0 under jnp.where), the port's 0."""
    err = np.full((2, C.AHO_LEN), 0.02, np.float32)
    portion = np.zeros((2, C.AHO_LEN), np.float32)
    portion[0, :10] = 1

    def j_score(e):
        return JA.nativeness_scores({'recon_error_pposi': e}, portion, 'VH').sum()

    j_grad = np.asarray(jax.grad(j_score)(jnp.asarray(err)))
    et = torch.from_numpy(err).requires_grad_()
    s = A.nativeness_scores({'recon_error_pposi': et}, torch.from_numpy(portion), 'VH')
    s.sum().backward()
    np.testing.assert_allclose(s.detach().numpy(),
                               np.asarray(JA.nativeness_scores(
                                   {'recon_error_pposi': jnp.asarray(err)}, portion, 'VH')),
                               rtol=0, atol=1e-6)
    assert s[1].item() == 1.0
    assert np.isnan(j_grad[1]).all() and (et.grad[1] == 0).all()
    np.testing.assert_allclose(et.grad[0].numpy(), j_grad[0], rtol=1e-6)


@pytest.mark.parametrize('hp_kw', [SMOKE, {}], ids=['smoke', 'released'])
def test_state_dict_round_trip_through_convert_torch_abnativ(hp_kw):
    _, variables, model = _pair(hp_kw, False, seed=7)
    ckpt = {'state_dict': model.state_dict(),
            'hyper_parameters': {'hparams': dataclasses.asdict(model.hp)}}
    conv = JA.convert_torch_abnativ(ckpt)
    assert dataclasses.asdict(conv['hp']) == dataclasses.asdict(model.hp)
    flat = jax.tree_util.tree_flatten_with_path(conv['variables'])[0]
    ref = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    assert len(flat) == len(ref)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), ref[path], err_msg=str(path))
        assert np.asarray(leaf).dtype == ref[path].dtype


def test_load_abnativ_reads_a_reference_layout_file(tmp_path):
    """The released files' layout: hparams nested under
    hyper_parameters['hparams'], a [1, n, d] codebook, and EMA statistics
    the scorer does not use."""
    _, variables, model = _pair(SMOKE, True, seed=9)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd['vqvae._codebook.embed'] = sd['vqvae._codebook.embed'][None]
    sd['vqvae._codebook.cluster_size'] = torch.ones(SMOKE['num_embeddings'])
    path = str(tmp_path / 'vh_model.ckpt')
    torch.save({'state_dict': sd, 'hyper_parameters': {'hparams': {
        **dataclasses.asdict(model.hp), 'learning_rate': 1e-3}}}, path)
    loaded = FTT.load_abnativ(path, straight_through=True, device='cpu')
    assert loaded.hp == model.hp and loaded.vqvae.straight_through
    assert not any(p.requires_grad for p in loaded.parameters()) and not loaded.training
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    conv = JA.convert_torch_abnativ(torch.load(path, weights_only=True))
    assert conv['hp'] == JA.AbNatiVParams(**SMOKE)
    written = FTT.save_abnativ(str(tmp_path / 'again.ckpt'), loaded)
    again = FTT.load_abnativ(written, straight_through=True, device='cpu')
    x = torch.from_numpy(_onehot(1, 2))
    assert torch.equal(again(x)['x_recon'], loaded(x)['x_recon'])
    with pytest.raises(FileNotFoundError):
        FTT.load_abnativ(str(tmp_path / 'missing.ckpt'), False, device='cpu')
    del sd['decoder.cnn_reconstruction.1.bias']
    torch.save({'state_dict': sd, 'hyper_parameters': dataclasses.asdict(model.hp)}, path)
    with pytest.raises(KeyError, match='cnn_reconstruction'):
        FTT.load_abnativ(path, True, device='cpu')
