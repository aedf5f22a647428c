"""The port's sampling variants against the JAX package, on the CPU: k > 1
sampling, the sequential reference sampler, pair inpainting
(``pair_inpaint_input``, ``PairHumanizer(inpaint=True)``, ``ab
--sample-method inpaint``) and the ``graft`` CLI.

The samplers are held against JAX's with toy forwards whose logits are
peaked by 1e4 at one token that depends on the whole current grid: both
loops must then give identical tokens whatever their random numbers.
Under real randomness only invariants are checked. ``pair_inpaint_input``
and the graft CLI's text must equal JAX's exactly.
"""
import csv
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu.models.denoiser import DenoiserConfig as JCfg
from hudiff_tpu.numbering import germline as JG
from hudiff_tpu.sampling import humanize as JH
from hudiff_tpu.sampling import sampler as JS
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.models.denoiser import DenoiserConfig
from hudiff_tpu_torch.numbering import germline as G
from hudiff_tpu_torch.numbering import regions as R
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
LAMBDA = JG.GERMLINE_V_LAMBDA['IGLV1-40*01'] + 'SLSGVV' + JG.GERMLINE_J_LAMBDA['IGLJ2*01']
CDR = np.concatenate([C.HEAVY_CDR_INDEX, C.LIGHT_CDR_INDEX]) != 0
L_TOY = 30


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist workers
    at once, and torch's default of a thread per core oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_peaked(t, *cond):
    tgt = (t.sum(axis=1, keepdims=True) + jnp.arange(t.shape[1])) % 22
    return 1e4 * jax.nn.one_hot(tgt, C.N_TOKENS)


def _torch_peaked(t, *cond):
    tgt = (t.sum(dim=1, keepdim=True) + torch.arange(t.shape[1])) % 22
    return 1e4 * torch.nn.functional.one_hot(tgt, C.N_TOKENS).float()


def _toy_case(seed, counts, pad_to):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(0, 22, (len(counts), L_TOY)).astype(np.int32)
    order = S.build_order_rows([rs.choice(L_TOY, n, replace=False) for n in counts],
                               rng=seed + 1, pad_to=pad_to)
    return tokens, order


def _both_scans(tokens, order, k):
    ref = np.asarray(JS.make_scan_sampler(_jax_peaked, positions_per_step=k)(
        jnp.asarray(tokens), jnp.asarray(order), jax.random.PRNGKey(3)))
    out = S.make_scan_sampler(_torch_peaked, positions_per_step=k)(
        torch.from_numpy(tokens).long(), torch.from_numpy(order).long(),
        torch.Generator().manual_seed(5)).numpy()
    return out, ref


@pytest.mark.parametrize('k', [2, 3, 7])
@pytest.mark.parametrize('seed', [0, 1])
def test_k_positions_per_step_matches_jax_when_logits_are_peaked(k, seed):
    # rows with different mask counts, one all -1, K = 13 a multiple of no k
    tokens, order = _toy_case(seed, (10, 7, 0, 13, 1), pad_to=13)
    out, ref = _both_scans(tokens, order, k)
    np.testing.assert_array_equal(out, ref)
    assert (out[2] == tokens[2]).all()                 # the all -1 row is untouched
    assert (out != tokens).any()


@pytest.mark.parametrize('row', [[0, -1], [-1, 0], [5, 0, -1], [-1, -1, 0, 9]])
@pytest.mark.parametrize('k', [2, 3])
def test_padded_slot_never_clobbers_a_position_0_write(row, k):
    """A -1 slot gathers position 0; its write must not undo a real write to
    position 0 in the same step."""
    tokens = np.full((2, L_TOY), 3, np.int32)
    order = np.asarray([row, [-1] * len(row)], np.int32)
    out, ref = _both_scans(tokens, order, k)
    np.testing.assert_array_equal(out, ref)
    assert out[0, 0] != 3 and (out[1] == 3).all()


@pytest.mark.parametrize('k', [2, 5])
def test_k_step_invariants_under_random_logits(k):
    B, L = 6, 40
    rs = np.random.RandomState(1)
    tokens = np.full((B, L), C.IDX_MSK, np.int64)
    sets = [rs.choice(L, rs.randint(1, L), replace=False) for _ in range(B)]
    order = torch.from_numpy(S.build_order_rows(sets, rng=2, pad_to=L)).long()
    logits = torch.randn(B, L, C.N_TOKENS, generator=torch.Generator().manual_seed(1)) * 3
    run = S.make_scan_sampler(lambda t: logits, positions_per_step=k)
    out = run(torch.from_numpy(tokens), order, torch.Generator().manual_seed(0)).numpy()
    for b, pos in enumerate(sets):
        touched = np.zeros(L, bool)
        touched[pos] = True
        assert (out[b, ~touched] == C.IDX_MSK).all()   # only ordered slots change
        assert (out[b, touched] < S.SAMPLE_TOP).all()  # draws never reach <msk>
    again = run(torch.from_numpy(tokens), order, torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(again, out)


@pytest.mark.parametrize('K,k', [(12, 1), (12, 2), (13, 3), (13, 7), (1, 4), (0, 3)])
def test_k_step_runs_ceil_k_over_positions_forwards(K, k):
    calls = []

    def apply_fn(t):
        calls.append(t.shape)
        return torch.zeros(*t.shape, C.N_TOKENS)

    tokens = torch.zeros(3, L_TOY, dtype=torch.long)
    order = torch.from_numpy(S.build_order_rows([np.arange(K)] * 3, rng=0, pad_to=K)).long()
    S.make_scan_sampler(apply_fn, positions_per_step=k)(tokens, order, torch.Generator())
    assert len(calls) == -(-K // k)


class _JaxToy:
    """A Flax-like model for JAX's sequential sampler: ``apply(p, t, region)``."""

    @staticmethod
    def apply(params, t, region):
        return _jax_peaked(t)


class _TorchToy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def forward(self, t, region):
        self.calls += 1
        return _torch_peaked(t)


def test_sequential_reference_sampler_matches_jax_when_logits_are_peaked():
    tokens, order = _toy_case(4, (11, 7, 0), pad_to=13)
    order[0, [2, 6]] = -1           # -1 slots are skipped; row 0's order serves every row
    region = np.zeros_like(tokens)
    ref = np.asarray(JS.sequential_reference_sampler(_JaxToy(), {}, has_chain_type=False)(
        jnp.asarray(tokens), jnp.asarray(region), jnp.asarray(order), jax.random.PRNGKey(0)))
    toy = _TorchToy()
    out = S.sequential_reference_sampler(toy)(
        torch.from_numpy(tokens).long(), torch.from_numpy(order).long(),
        torch.Generator().manual_seed(1), torch.from_numpy(region).long()).numpy()
    np.testing.assert_array_equal(out, ref)
    assert toy.calls == int((order[0] >= 0).sum())
    moved = (out != tokens).any(axis=0)
    assert not moved[np.setdiff1d(np.arange(L_TOY), order[0])].any()


def test_build_order_shuffles_each_row():
    order = S.build_order([4, 8, 15, 16, 23, 42], 5, rng=0, pad_to=8)
    assert order.shape == (5, 8) and (order[:, 6:] == -1).all()
    assert all(sorted(r[:6]) == [4, 8, 15, 16, 23, 42] for r in order)
    assert len({tuple(r) for r in order}) > 1
    np.testing.assert_array_equal(S.build_order([3, 1], 2, shuffle=False), [[3, 1], [3, 1]])


def _assert_same_input(got, ref):
    assert got is not None and set(got) == set(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize('pair', [(H1, L1), (H2, L2), (H1, LAMBDA)], ids=['mouse', 'human', 'lambda'])
def test_pair_inpaint_input_matches(pair):
    _assert_same_input(H.pair_inpaint_input(*pair), JH.pair_inpaint_input(*pair))


@pytest.mark.parametrize('group', ['H', 'K'])
def test_pair_inpaint_input_consensus_fallback_matches(group, monkeypatch):
    """With a chain's germline library empty, graft_cdrs raises and both
    packages take the consensus template for that chain."""
    for mod in (G, JG):
        monkeypatch.setitem(mod._V_BY_GROUP, group, {})
        monkeypatch.setattr(mod, '_GRID_CACHE', {})
    got, ref = H.pair_inpaint_input(H1, L1), JH.pair_inpaint_input(H1, L1)
    _assert_same_input(got, ref)
    monkeypatch.undo()
    assert not np.array_equal(got['positions'], H.pair_inpaint_input(H1, L1)['positions'])


def test_pair_inpaint_input_rejects_like_jax():
    for pair in ((H1, H1), ('AAAA', L1)):
        assert H.pair_inpaint_input(*pair) is None and JH.pair_inpaint_input(*pair) is None


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


@pytest.mark.parametrize('k', [1, 2])
def test_pair_humanizer_inpaint_keeps_cdrs_and_frozen_slots(demo_ckpt, k):
    model, _ = H.load_denoiser(demo_ckpt, 'pair', device='cpu', use_bf16=False)
    hum = H.PairHumanizer(model, batch_size=3, seed=11, device='cpu', positions_per_step=k)
    inp = H.pair_inpaint_input(H1, L1)
    res = hum(H1, L1, inpaint=True)
    grids = res['grids']
    assert grids.shape == (3, C.PAIR_LEN) and (grids != C.IDX_MSK).all()
    frozen = inp['tokens'] != C.IDX_MSK          # CDRs and germline-identical FR slots
    assert frozen[CDR].all() and (frozen & ~CDR).any()
    np.testing.assert_array_equal(grids[:, frozen],
                                  np.broadcast_to(inp['clean'][frozen], (3, frozen.sum())))
    assert (grids[:, inp['positions']] < S.SAMPLE_TOP).all()


def _cdrs(h_seq, l_seq):
    return [R.region_sequences(h_seq, True, 'H')[c] for c in ('cdr1', 'cdr2', 'cdr3')] + [
        R.region_sequences(l_seq, False, 'K')[c] for c in ('cdr1', 'cdr2', 'cdr3')]


def test_cli_ab_inpaint_with_two_positions_per_step(demo_ckpt, tmp_path):
    data = tmp_path / 'mice.csv'
    with open(data, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['name', 'type', 'h_seq', 'l_seq'])
        w.writerows([['abA', 'mouse', H1, L1], ['abB', 'mouse', H2, L2]])
    out = H.main(['ab', '--ckpt', demo_ckpt, '--data-fpath', str(data), '--device', 'cpu',
                  '--fp32', '--batch-size', '2', '--pack-size', '4', '--max-retry', '1',
                  '--sample-method', 'inpaint', '--positions-per-step', '2',
                  '--logdir', str(tmp_path / 'logs')])
    with open(out, newline='') as f:
        rows = list(csv.DictReader(f))
    assert [r['Specific'] for r in rows] == ['mouse', 'humanization'] * 2
    for (h_seq, l_seq), hum in zip(((H1, L1), (H2, L2)), rows[1::2]):
        assert _cdrs(hum['hseq'], hum['lseq']) == _cdrs(h_seq, l_seq)


def _graft_text(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize('back', [[], ['--back-mutation']])
def test_graft_cli_text_equals_jax(back, tmp_path, capsys):
    seqs = ['graft', '--hseq', H1, '--lseq', L1, *back]
    ours = _graft_text(H.main, seqs, capsys)
    assert ours == _graft_text(JH.main, seqs, capsys)
    assert ours.startswith('Specific,name,hseq,lseq\ncdr_graft,graft_sample,')
    data = tmp_path / 'mice.csv'
    with open(data, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(['name', 'type', 'h_seq', 'l_seq'])
        w.writerows([['abA', 'mouse', H1, L1], ['junk', 'mouse', 'AAAAGGGG', L2],
                     ['hum', 'humanized', H2, L2], ['abB', 'mouse', H2, LAMBDA]])
    ours = _graft_text(H.main, ['graft', '--data-fpath', str(data), *back], capsys)
    assert ours == _graft_text(JH.main, ['graft', '--data-fpath', str(data), *back], capsys)
    assert [line.split(',')[0] for line in ours.splitlines()] == [
        'Specific', 'mouse', 'humanization', 'mouse', 'mouse', 'humanization']
    for name, main in (('ours.csv', H.main), ('theirs.csv', JH.main)):
        assert main(['graft', '--data-fpath', str(data), '--output',
                     str(tmp_path / name), *back]) == str(tmp_path / name)
    capsys.readouterr()
    assert (tmp_path / 'ours.csv').read_bytes() == (tmp_path / 'theirs.csv').read_bytes()


def test_graft_cli_needs_input():
    with pytest.raises(SystemExit, match='graft needs'):
        H.main(['graft'])
