"""The port's dataset tools (hudiff_tpu_torch/tools/{germline_margin,
pps_quality,regen_demo_eval,migrate_qkv_layout}.py) against the JAX
package's (tools/*.py), on the CPU.

No dataset is in the repository, so both tools read CSVs built from the
repository's chains (``chip_smoke.repo_chain_csvs``: sixteen mouse-like
pairs with their germline grafts as the humanized group, and eight VHHs),
their ``HUAB348`` / ``VHH_CSV`` constants pointed at them.

- ``germline_margin``: the JSON equal to the JAX tool's.
- ``pps_quality``: ``mean_ci`` equal; ``eval_one_setting`` at k = 1 with a
  toy denoiser whose logits are peaked by 1e4 at a token that depends on
  the position alone (a human pair's grid, so the sampled grids depend on
  neither the order nor the random numbers, and realign) equal to JAX's;
  under a model ``train_tiny`` trained a few steps its invariants at k = 4
  and 8; ``main`` end to end at a tiny size.
- ``regen_demo_eval``: subset mode end to end on a 3-antibody CSV and on
  three VHHs (the port's CLIs on the Orbax demos; the bands read at that
  n, as chip_smoke.py reads them), and ``regen_ab`` holding every band as
  the JAX tool does; an unset CSV constant is refused.
- ``migrate_qkv_layout``: a part-major copy of the Ab demo (written by JAX's
  ``save``) migrated into a port run directory gives the demo's logits;
  a head-major or unmarked directory is refused without ``--legacy``.
"""
import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hudiff_tpu.sampling import humanize as JH
from hudiff_tpu.training import checkpoints as JCK
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.sampling import humanize as H
from hudiff_tpu_torch.tools import germline_margin as GM
from hudiff_tpu_torch.tools import migrate_qkv_layout as MIG
from hudiff_tpu_torch.tools import pps_quality as PPS
from hudiff_tpu_torch.tools import regen_demo_eval as RG
from hudiff_tpu_torch.training import checkpoints as CK

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
import germline_margin as JGM  # noqa: E402
import migrate_qkv_layout as JMIG  # noqa: E402
import pps_quality as JPPS  # noqa: E402

DEMO_AB = os.path.join(REPO, 'examples', 'demo_ab_tiny')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def csvs(tmp_path_factory):
    return chip_smoke.repo_chain_csvs(str(tmp_path_factory.mktemp('chains')))


def _stdout_json(fn):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return json.loads(buf.getvalue())


# -- germline_margin ------------------------------------------------------------------

def test_germline_margin_equals_jax(csvs, monkeypatch):
    monkeypatch.setattr(JGM, 'HUAB348', csvs[0])
    monkeypatch.setattr(GM, 'HUAB348', csvs[0])
    want = _stdout_json(JGM.main)
    got = _stdout_json(GM.main)
    assert got == want
    assert got['H']['n_chains'] == 32 and got['K']['n_chains'] > 0


# -- pps_quality ----------------------------------------------------------------------

@pytest.mark.parametrize('vals', [[0.5], [0.7, 0.9], [0.81, 0.84, 0.8], list(np.linspace(0, 1, 12))])
def test_mean_ci_equals_jax(vals):
    got, want = PPS.mean_ci(vals), JPPS.mean_ci(vals)
    np.testing.assert_equal(got, want)


H2 = ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYAMSWVRQAPGKGLEWVSAISGSGGSTYY'
      'ADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAKDRGYYFDYWGQGTLVTVSS')
L2 = ('EIVLTQSPGTLSLSPGERATLSCRASQSVSSSYLAWYQQKPGQAPRLLIYGASSRATGIP'
      'DRFSGSGSGTDFTLTISRLEPEDFAVYYCQQYGSSPLTFGGGTKVEIK')


def _target(L):
    """A token a position, whatever the grid: a human pair's own grid, so
    that every sampled framework is human and realigns."""
    assert L == C.PAIR_LEN
    return H.pair_input(H2, L2)['clean']


class _JaxPeaked:
    """A Flax-like denoiser: ``apply(params, tokens, region, chain)``."""

    @staticmethod
    def apply(params, t, region, chain):
        tgt = jnp.asarray(_target(t.shape[1]))[None].repeat(t.shape[0], 0)
        return 1e4 * jax.nn.one_hot(tgt, C.N_TOKENS)


class _TorchPeaked(torch.nn.Module):
    def forward(self, t, region, chain):
        tgt = torch.as_tensor(_target(t.shape[1]), dtype=torch.long,
                              device=t.device).expand(t.shape[0], -1)
        return 1e4 * torch.nn.functional.one_hot(tgt, C.N_TOKENS).float()


def test_eval_one_setting_at_k1_equals_jax_under_peaked_logits(csvs, monkeypatch):
    monkeypatch.setattr(JPPS, 'HUAB348', csvs[0])
    monkeypatch.setattr(PPS, 'HUAB348', csvs[0])
    mice, jmice = PPS.load_mice(5), JPPS.load_mice(5)
    assert [m[0] for m in mice] == [m[0] for m in jmice] and len(mice) == 5
    jhum = JH.PairHumanizer(_JaxPeaked(), {}, batch_size=3, device_batch=8)
    hum = H.PairHumanizer(_TorchPeaked(), batch_size=3, device_batch=8, device='cpu')
    want = JPPS.eval_one_setting(jhum, jmice, 2024, 3)
    got = PPS.eval_one_setting(hum, mice, 2024, 3)
    assert got == want
    assert got['cdr_invariant'] and got['preservation_h'] < 1.0


def test_eval_one_setting_invariants_on_a_trained_model(csvs, monkeypatch):
    monkeypatch.setattr(PPS, 'HUAB348', csvs[0])
    model = PPS.train_tiny(3, device='cpu')
    mice = PPS.load_mice(2)
    for k in (8, 4):
        hum = H.PairHumanizer(model, batch_size=2, device_batch=4, device='cpu',
                              positions_per_step=k)
        out = PPS.eval_one_setting(hum, mice, 2023, 2)
        assert out['cdr_invariant']
        for m in ('preservation_h', 'preservation_l'):
            assert 0.0 < out[m] <= 1.0, m
        for m in ('germline_fr_h', 'germline_fr_l'):   # NaN when no best row realigns
            assert np.isnan(out[m]) or 0.0 < out[m] <= 1.0, m
    # the same seed gives the same rows
    np.testing.assert_equal(PPS.eval_one_setting(hum, mice, 2023, 2), out)


def test_pps_quality_main_end_to_end(csvs, monkeypatch):
    monkeypatch.setattr(PPS, 'HUAB348', csvs[0])
    out = PPS.main(['--train-steps', '2', '--n-mice', '2', '--seeds', '1,2',
                    '--rows-per-mouse', '2', '--device-batch', '4', '--ks', '4,8',
                    '--device', 'cpu'])
    assert out['n_mice'] == 2 and set(out['per_k']) == {4, 8}
    assert out['per_k'][4]['cdr_invariant'] and out['per_k'][8]['cdr_invariant']
    assert 'd_preservation_h_vs_k1' in out['per_k'][8]   # the drift against the first k


# -- regen_demo_eval ------------------------------------------------------------------

@pytest.fixture
def _cli_threads(monkeypatch):
    """The CLI processes the tool starts take two torch threads each (the
    suite runs in several workers at once)."""
    monkeypatch.setenv('OMP_NUM_THREADS', '2')


def test_regen_ab_subset_end_to_end(csvs, monkeypatch, _cli_threads):
    """The subset pipeline through the port's CLIs; at three antibodies the
    bands are readings (a few antibodies do not make a mean), as
    chip_smoke.py takes them."""
    monkeypatch.setattr(RG, 'HUAB348', csvs[0])
    stages = {}
    report, samples = RG._regen('ab', 3, 2023, 'cpu', stages)
    bands = RG.check_ab_bands(report, 3)
    assert report['n_matched'] == 3 and report['n_skipped_unmatched'] == 0 and len(samples) == 3
    assert bands['n_matched'] and set(bands) == {
        'n_matched', 'germline_fr_identity_h', 'germline_fr_identity_l',
        'preservation_all_h', 'preservation_all_l', 'n_skipped_unmatched'}
    assert 0 < report['preservation_all_h'] <= 1
    assert stages['humanize_s'] > 0 and stages['harness_s'] > 0


def test_regen_nano_subset_end_to_end(csvs, monkeypatch, _cli_threads):
    monkeypatch.setattr(RG, 'VHH_CSV', csvs[1])
    report, samples = RG._regen('nano', 3, 2023, 'cpu', {})
    assert report['n_matched'] == 3 and RG.check_nano_bands(report, 3)['n_matched']
    assert 0 < report['preservation_all'] <= 1 and len(samples) == 3


_AB_IN_BANDS = {'n_matched': 4, 'n_skipped_unmatched': 0, 'germline_fr_identity_h': 0.85,
                'germline_fr_identity_l': 0.85, 'preservation_all_h': 0.8,
                'preservation_all_l': 0.8}


@pytest.mark.parametrize('band,value', [(None, None), ('germline_fr_identity_l', 0.77),
                                        ('preservation_all_h', 0.6), ('n_matched', 2),
                                        ('n_skipped_unmatched', 1)])
def test_regen_holds_every_band_in_subset_mode(monkeypatch, band, value):
    """As the JAX tool does, ``regen_ab`` holds every band, also with
    ``--subset``; each band out of range raises."""
    report = dict(_AB_IN_BANDS, **({band: value} if band else {}))
    monkeypatch.setattr(RG, '_regen', lambda *a: (dict(report), []))
    if band is None:
        assert all(RG.regen_ab(subset=4, write=False)['bands'].values())
    else:
        with pytest.raises(AssertionError, match=band):
            RG.regen_ab(subset=4, write=False)


def test_tools_refuse_an_unset_dataset_csv(monkeypatch):
    monkeypatch.setattr(RG, 'HUAB348', None)
    with pytest.raises(SystemExit, match='HUAB348 is unset'):
        RG.regen_ab(subset=2, write=False)
    monkeypatch.setattr(GM, 'HUAB348', None)
    with pytest.raises(SystemExit, match='HUAB348 is unset'):
        GM.main()


def test_regen_refuses_write_with_subset():
    with pytest.raises(SystemExit):
        RG.main(['ab', '--subset', '2', '--write'])


# -- migrate_qkv_layout ---------------------------------------------------------------

def test_headmajor_perm_equals_jax():
    np.testing.assert_array_equal(MIG.headmajor_perm(8, 512), JMIG.headmajor_perm(8, 512))
    np.testing.assert_array_equal(MIG.headmajor_perm(4, 64), JMIG.headmajor_perm(4, 64))


def test_migrate_a_part_major_copy(tmp_path):
    """JAX's save writes the demo back with its qkv columns permuted to the
    legacy part-major layout (the inverse of the migration); the port's tool
    reads it without JAX and writes a port run directory whose model gives
    the demo's logits, with Adam's moments permuted alike."""
    restored = JCK.restore(DEMO_AB)
    payload = jax.tree_util.tree_map(np.asarray, restored['payload'])
    cfg = restored['meta']['config']['model']
    inv = np.argsort(MIG.headmajor_perm(cfg['nhead'], cfg['att_model']))
    legacy = jax.tree_util.tree_map(lambda a: a, payload)
    n = 0
    for blk in legacy['params']['params']['self_att'].values():
        for att in ('attn', 'attn_c'):
            blk[att]['qkv'] = {k: v[..., inv] for k, v in blk[att]['qkv'].items()}
            n += 1
    # an Adam state shaped like the parameters, also part-major
    rs = np.random.RandomState(0)
    mu = jax.tree_util.tree_map(lambda a: rs.standard_normal(a.shape).astype(np.float32),
                                payload['params'])
    opt = [None, {'count': np.asarray(5, np.int32), 'mu': mu,
                  'nu': jax.tree_util.tree_map(np.abs, mu)}]
    legacy_mu = jax.tree_util.tree_map(lambda a: a, mu)
    for blk in legacy_mu['params']['self_att'].values():
        for att in ('attn', 'attn_c'):
            blk[att]['qkv'] = {k: v[..., inv] for k, v in blk[att]['qkv'].items()}
    opt[1]['mu'], opt[1]['nu'] = legacy_mu, jax.tree_util.tree_map(np.abs, legacy_mu)
    src = str(tmp_path / 'legacy')
    JCK.save(src, 600, legacy['params'], opt, config=restored['meta']['config'],
             extra={k: v for k, v in restored['meta'].items() if k not in ('step', 'config')})
    out = str(tmp_path / 'port_run')
    with pytest.raises(ValueError, match='--legacy'):
        MIG.migrate(src, out)
    with open(os.path.join(src, '.qkv_layout'), 'w') as f:
        f.write('part-major\n')
    before = sorted(os.listdir(src))
    path = MIG.main([src, out])
    assert sorted(os.listdir(src)) == before          # the Orbax directory is untouched
    assert path == os.path.join(out, 'step_600.pt')

    want_model, want_finetuned = H.load_denoiser(DEMO_AB, 'pair', device='cpu',
                                                 use_bf16=False)
    got_model, got_finetuned = H.load_denoiser(out, 'pair', device='cpu', use_bf16=False)
    assert got_finetuned is want_finetuned
    rs = np.random.RandomState(1)
    tokens = torch.from_numpy(rs.randint(0, C.N_TOKENS, (2, C.PAIR_LEN))).long()
    region = torch.from_numpy(np.tile(np.concatenate(
        [C.HEAVY_REGION_INDEX, C.LIGHT_REGION_INDEX]), (2, 1))).long()
    chain = torch.tensor([[0, 1], [0, 2]])
    with torch.no_grad():
        np.testing.assert_array_equal(got_model(tokens, region, chain).numpy(),
                                      want_model(tokens, region, chain).numpy())
    # the moments went through the same permutation and the name map
    restored_port = CK.restore(out)
    exp_avg = restored_port['payload']['optimizer']['state']
    names = [k for k, _ in got_model.named_parameters()]
    want_mu = CK.flax_to_state_dict(mu, got_model.cfg)
    for i, name in enumerate(names):
        np.testing.assert_array_equal(exp_avg[i]['exp_avg'].numpy(), want_mu[name].numpy())
        assert float(exp_avg[i]['step']) == 5
    assert restored_port['meta']['step'] == 600

    shutil.copytree(DEMO_AB, str(tmp_path / 'head_major'))
    with pytest.raises(ValueError, match='already head-major'):
        MIG.migrate(str(tmp_path / 'head_major'), str(tmp_path / 'x'))
    assert n == 2 * len(payload['params']['params']['self_att'])
