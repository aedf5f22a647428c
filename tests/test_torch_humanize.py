"""Port host prep, sampler and humanization CLI (hudiff_tpu_torch/sampling/)
against the JAX package.

- ``pair_input`` must give arrays identical to the JAX package's.
- The sampler loop is held against JAX's ``make_scan_sampler`` with a toy
  forward whose logits are peaked by 1e4 at one token that depends on the
  current grid: both loops must then give identical tokens whatever their
  random numbers. Under real randomness only invariants are checked, never
  equal tokens.
- Humanization and the ``ab`` CLI run on the CPU with the in-repo demo
  checkpoint, exported to a port checkpoint: every CDR slot stays the
  parental residue.
"""
import csv
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu import constants as JC
from hudiff_tpu.models.denoiser import DenoiserConfig as JCfg
from hudiff_tpu.sampling import humanize as JH
from hudiff_tpu.sampling import sampler as JS
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.models.denoiser import DenoiserConfig
from hudiff_tpu_torch.sampling import humanize as H
from hudiff_tpu_torch.sampling import sampler as S
from hudiff_tpu_torch.training import checkpoints as CK

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
H2 = ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYAMSWVRQAPGKGLEWVSAISGSGGSTYY'
      'ADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAKDRGYYFDYWGQGTLVTVSS')
L2 = ('EIVLTQSPGTLSLSPGERATLSCRASQSVSSSYLAWYQQKPGQAPRLLIYGASSRATGIP'
      'DRFSGSGSGTDFTLTISRLEPEDFAVYYCQQYGSSPLTFGGGTKVEIK')
CDR = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX]) != 0


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist workers
    at once, and torch's default of a thread per core oversubscribes the
    cores, which slows these many small ops several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('finetune', [False, True])
@pytest.mark.parametrize('pair', [(H1, L1), (H2, L2)])
def test_pair_input_matches(pair, finetune):
    got = H.pair_input(*pair, finetune=finetune)
    ref = JH.pair_input(*pair, finetune=finetune)
    assert got is not None and set(got) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


def test_pair_input_rejects_like_jax():
    for pair in ((H1, H1), (L1, L1), (123, L1)):
        assert H.pair_input(*pair) is None and JH.pair_input(*pair) is None


def test_bucketing_helpers_match():
    for k, cap in ((55, 185), (64, 185), (65, 185), (185, 185), (300, 185), (0, 185), (1, 20)):
        assert H._bucket_order_width(k, cap) == JH._bucket_order_width(k, cap)
    for n, cap in ((1, 256), (4, 256), (5, 256), (300, 256), (0, 256), (9, 8)):
        assert H._bucket_batch(n, cap) == JH._bucket_batch(n, cap)


def test_packed_batch_policy_matches_jax():
    """Same chunking and batch-reuse decisions as the JAX package's
    iter_packed_chunks, wave after wave."""
    class Spy:
        device_batch = 256

        def __init__(self):
            self.batches = []

        def sample_rows(self, rows, pad_to, batch=None):
            self.batches.append((len(rows), batch, pad_to))
            return np.zeros((len(rows), 4), np.int32)

    stream = [(i, {'x': 1}) for i in range(40)]
    waves = [(stream, 8), (stream[:3], 8), (stream[:5], 16), (stream[:300], 8)]
    ours, theirs = Spy(), Spy()
    for wave, pad_to in waves:
        list(H.iter_packed_chunks(ours, wave, pad_to))
        list(JH.iter_packed_chunks(theirs, wave, pad_to))
    assert ours.batches == theirs.batches


def test_build_order_rows():
    sets = [np.array([3, 7, 11]), np.array([1, 2]), np.array([5])]
    order = S.build_order_rows(sets, rng=0, pad_to=4)
    assert order.shape == (3, 4) and order.dtype == np.int32
    for row, pos in zip(order, sets):
        assert sorted(row[row >= 0].tolist()) == sorted(pos.tolist())
        assert (row[len(pos):] == -1).all()
    np.testing.assert_array_equal(S.build_order_rows(sets, rng=0, pad_to=4), order)
    np.testing.assert_array_equal(
        S.build_order_rows([np.array([9, 4, 2])], shuffle=False, pad_to=3)[0], [9, 4, 2])


def test_sampler_matches_jax_when_logits_are_peaked():
    B, L = 4, 30
    rs = np.random.RandomState(0)
    tokens = rs.randint(0, 22, (B, L)).astype(np.int32)
    order = S.build_order_rows([rs.choice(L, n, replace=False) for n in (10, 7, 0, 12)],
                               rng=1, pad_to=12)

    # the forced token depends on the whole current grid
    def jax_apply(t):
        tgt = (t.sum(axis=1, keepdims=True) + jnp.arange(L)) % 22
        return 1e4 * jax.nn.one_hot(tgt, JC.N_TOKENS)

    def torch_apply(t):
        tgt = (t.sum(dim=1, keepdim=True) + torch.arange(L)) % 22
        return 1e4 * torch.nn.functional.one_hot(tgt, C.N_TOKENS).float()

    ref = np.asarray(JS.make_scan_sampler(jax_apply)(
        jnp.asarray(tokens), jnp.asarray(order), jax.random.PRNGKey(3)))
    gen = torch.Generator().manual_seed(5)
    out = S.make_scan_sampler(torch_apply)(torch.from_numpy(tokens).long(),
                                           torch.from_numpy(order).long(), gen).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out[2] == tokens[2]).all()  # an all -1 row is untouched


def test_sampler_invariants_under_random_logits():
    B, L = 6, 40
    rs = np.random.RandomState(1)
    tokens = np.full((B, L), C.IDX_MSK, np.int64)
    sets = [rs.choice(L, rs.randint(1, L), replace=False) for _ in range(B)]
    order = torch.from_numpy(S.build_order_rows(sets, rng=2, pad_to=L)).long()
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(B, L, C.N_TOKENS, generator=torch.Generator().manual_seed(1)) * 3
    out = S.make_scan_sampler(lambda t: logits)(torch.from_numpy(tokens), order, gen).numpy()
    for b, pos in enumerate(sets):
        touched = np.zeros(L, bool)
        touched[pos] = True
        assert (out[b, ~touched] == C.IDX_MSK).all()   # only ordered slots change
        assert (out[b, touched] < S.SAMPLE_TOP).all()  # draws never reach <msk>
    # the generator is the only source of randomness: same seed, same tokens
    again = S.make_scan_sampler(lambda t: logits)(
        torch.from_numpy(tokens), order, torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(again, out)


@pytest.fixture(scope='module')
def demo_ckpt(tmp_path_factory):
    """examples/demo_ab_tiny restored through the JAX package and exported
    as a port checkpoint."""
    from hudiff_tpu.training.checkpoints import restore
    restored = restore(os.path.join(REPO, 'examples', 'demo_ab_tiny'))
    cfg = DenoiserConfig(**JCfg.from_dict(restored['meta']['config']['model']).__dict__)
    tree = jax.tree_util.tree_map(np.asarray, restored['payload']['params'])
    path = str(tmp_path_factory.mktemp('port_ckpt') / 'demo_ab_tiny.pt')
    return CK.save(path, CK.from_flax_params(tree, cfg, device='cpu'), cfg)


def test_cuda_entry_points_raise_without_a_card(demo_ckpt):
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        H.load_denoiser(demo_ckpt, 'pair')
    model, _ = H.load_denoiser(demo_ckpt, 'pair', device='cpu', use_bf16=False)
    with pytest.raises(RuntimeError, match='CUDA'):
        H.PairHumanizer(model)


def test_humanize_many_keeps_cdrs(demo_ckpt):
    model, finetuned = H.load_denoiser(demo_ckpt, 'pair', device='cpu', use_bf16=False)
    assert not finetuned
    hum = H.PairHumanizer(model, batch_size=2, seed=7, device='cpu', device_batch=5)
    inputs = [H.pair_input(H1, L1), H.pair_input(H2, L2), None]
    results = hum.humanize_many(inputs, rows_per_input=2)
    assert results[2] is None
    for inp, res in zip(inputs[:2], results[:2]):
        grids = res['grids']
        assert grids.shape == (2, C.PAIR_LEN) and (grids != C.IDX_MSK).all()
        np.testing.assert_array_equal(grids[:, CDR],
                                      np.broadcast_to(inp['clean'][CDR], (2, CDR.sum())))
        keep = inp['tokens'] != C.IDX_MSK
        np.testing.assert_array_equal(grids[:, keep], np.broadcast_to(
            inp['tokens'][keep], (2, keep.sum())))
        assert 0 <= res['best_idx'] < 2


def _cdr_strings(grid_row):
    """Each CDR's residues (pads dropped), from the parental 291 grid."""
    out = []
    cdr_id = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX])
    for chain, sl in (('h', slice(0, C.HEAVY_LEN)), ('l', slice(C.HEAVY_LEN, None))):
        ids, row = cdr_id[sl], grid_row[sl]
        for k in np.unique(ids[ids != 0]):
            out.append((chain, ''.join(C.TOKENS[t] for t in row[ids == k] if t != C.IDX_PAD)))
    return out


def test_cli_ab_writes_csv_and_keeps_cdrs(demo_ckpt, tmp_path):
    data = tmp_path / 'mice.csv'
    with open(data, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['name', 'type', 'h_seq', 'l_seq'])
        w.writerows([['abA', 'mouse', H1, L1], ['abB', 'mouse', H2, L2]])
    out = H.main(['ab', '--ckpt', demo_ckpt, '--data-fpath', str(data), '--device', 'cpu',
                  '--fp32', '--batch-size', '2', '--pack-size', '4', '--max-retry', '1',
                  '--logdir', str(tmp_path / 'logs')])
    with open(out, newline='') as f:
        rows = list(csv.DictReader(f))
    assert [r['Specific'] for r in rows] == ['mouse', 'humanization'] * 2
    assert glob.glob(os.path.join(os.path.dirname(out), 'sample_identity.fa'))
    for (h_seq, l_seq), hum in zip(((H1, L1), (H2, L2)), rows[1::2]):
        clean = H.pair_input(h_seq, l_seq)['clean']
        for chain, cdr in _cdr_strings(clean):
            assert cdr in hum['hseq' if chain == 'h' else 'lseq']
