"""The port's evaluation path (hudiff_tpu_torch/eval/: metrics, plots, web,
harness) against the JAX package on the CPU.

Mirrors tests/test_eval_metrics.py, test_harness_pairing.py, test_plots.py
and test_web_eval.py: each test feeds the same inputs to both packages.
The JAX tests that need the reference's eval CSVs (HuAb348, Humab25, the
putative set) run here on CSVs built from the tests' chains in the same
layouts: an ``order_name`` pair CSV whose experimental partners are CDR
grafts, a shared-name one, a Humab25-style experimental CSV. ``eval_ab``
and ``eval_nano`` must give JAX's report on the same CSVs: every key,
counts exact, floats within 1e-9, AbNatiV scores (``abnativ_scores_local``
at smoke hparams, f32) within 1e-5. The port reads CSVs with ``csv``; the
names used here are not numbers, which pandas would parse
(ROADMAP.md, queue 3).
"""
import csv
import os

import numpy as np
import pandas as pd
import pytest
import torch

from hudiff_tpu import constants as JC
from hudiff_tpu.eval import harness as JH
from hudiff_tpu.eval import metrics as JM
from hudiff_tpu.eval import plots as JP
from hudiff_tpu.eval import web as jweb
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch.eval import harness as H
from hudiff_tpu_torch.eval import metrics as M
from hudiff_tpu_torch.eval import plots as P
from hudiff_tpu_torch.eval import web
from hudiff_tpu_torch.numbering import germline as G
from hudiff_tpu_torch.training import finetune as FT

VH = ('EVKLEESGGGLVQPGGSMKLSCVASGFTFSNFWMDWVRQSPEKGLEWIAGIRLKSYNYATHYAESVKG'
      'RFTISRDDSKSSVYLQMNNLRAEDTGIYYCTDWDGAYWGQGTLVTVSA')
VH_HUM = ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSNFWMDWVRQAPGKGLEWVGGIRLKSYNYATHYAES'
          'VKGRFTISRDDSKNTAYLQMNSLRAEDTAVYYCTRWDGAYWGQGTLVTVSS')
H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
H2 = ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYAMSWVRQAPGKGLEWVSAISGSGGSTYY'
      'ADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAKDRGYYFDYWGQGTLVTVSS')
L2 = ('EIVLTQSPGTLSLSPGERATLSCRASQSVSSSYLAWYQQKPGQAPRLLIYGASSRATGIP'
      'DRFSGSGSGTDFTLTISRLEPEDFAVYYCQQYGSSPLTFGGGTKVEIK')
LAMBDA = ('QSALTQPASVSGSPGQSITISCTGTSSDVGGYNYVSWYQQHPGKAPKLMIYEVSNRPSGVSN'
          'RFSGSKSGNTASLTISGLQAEDEADYYCSSYTSSSTLVFGGGTKLTVL')
VHH = ('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADS'
       'VKGRFTISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')
MOUSE = {'A': (H1, L1), 'B': (VH, L2), 'C': (H2, LAMBDA), 'D': (H1, L2), 'E': (VH, L1)}
EXPERIMENTAL = {name: G.cdr_pair_grafting(*pair) for name, pair in MOUSE.items()}
SAMPLE_COLS = ['Specific', 'name', 'hseq', 'lseq']


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: the suite runs in several xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, columns, rows):
    with open(path, 'w', newline='') as f:
        w = csv.writer(f)
        w.writerow(columns)
        w.writerows(rows)
    return str(path)


def _pair_csv(path, layout='order_name'):
    """The mouse group, then the experimental group (CDR grafts); linked by
    ``order_name`` (HuAb348), by shared names (the putative set) or by
    nothing but position."""
    rows = []
    for kind, table, suffix in (('mouse', MOUSE, 'mouse'), ('humanized', EXPERIMENTAL, 'humanized')):
        for i, (name, (h, l)) in enumerate(table.items()):
            if layout == 'order_name':
                rows.append([kind, name if kind == 'mouse' else f'h{name}-{i}',
                             f'{i}_{suffix}', h, l])
            else:
                rows.append([kind, name if layout == 'name' or kind == 'mouse'
                             else f'h{name}', h, l])
    cols = ['type', 'name', 'order_name', 'h_seq', 'l_seq'] if layout == 'order_name' \
        else ['type', 'name', 'h_seq', 'l_seq']
    return _write(path, cols, rows)


def _sample_csv(path, rows):
    return _write(path, SAMPLE_COLS, [('humanization', *r) for r in rows])


def _assert_reports_match(got, want, abnativ_tol=1e-5):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if w is None or isinstance(w, (str, bool)):
            assert g == w, k
        elif isinstance(w, (int, np.integer)):
            assert g == w and isinstance(g, int), k
        else:
            tol = abnativ_tol if k.startswith('abnativ') else 1e-9
            assert g == pytest.approx(float(w), abs=tol), k


# -- metrics (tests/test_eval_metrics.py) ---------------------------------------

def _chains(seq, heavy=True, hint='H'):
    return M.GridChain(seq, heavy, hint), JM.GridChain(seq, heavy, hint)


def test_self_preservation_is_one():
    a, ja = _chains(VH)
    for fn in ('all_preservation', 'vernier_preservation', 'fr_preservation'):
        assert getattr(M, fn)(a, a) == getattr(JM, fn)(ja, ja) == 1.0


def test_preservation_ordering():
    (mouse, jmouse), (hum, jhum) = _chains(VH), _chains(VH_HUM)
    p = M.all_preservation(hum, mouse)
    assert p == JM.all_preservation(jhum, jmouse) and 0.7 < p < 1.0
    assert M.vernier_preservation(hum, mouse) == JM.vernier_preservation(jhum, jmouse)
    assert M.fr_preservation(hum, mouse, 'kabat') == JM.fr_preservation(jhum, jmouse, 'kabat')
    loops12 = np.isin(C.HEAVY_CDR_INDEX, (1, 2))
    occ = (mouse.grid != '-') & loops12
    assert (mouse.grid[occ] == hum.grid[occ]).all()
    np.testing.assert_array_equal(mouse.grid, jmouse.grid)


def test_mutation_precision_perfect_match():
    (mouse, jmouse), (exp, jexp) = _chains(VH), _chains(VH_HUM)
    assert M.mutation_precision(exp, mouse, exp) == JM.mutation_precision(jexp, jmouse, jexp) == 1.0
    r = M.mutation_precision(exp, mouse, mouse)
    assert r == JM.mutation_precision(jexp, jmouse, jmouse)
    assert r is None or r == 0.0
    assert (M.mutation_precision(exp, mouse, exp, vernier_only=True)
            == JM.mutation_precision(jexp, jmouse, jexp, vernier_only=True))


def test_consensus_identity_ranges():
    (hum, jhum), (mouse, jmouse) = _chains(VH_HUM), _chains(VH)
    ih, im = M.consensus_identity(hum), M.consensus_identity(mouse)
    assert (ih, im) == (JM.consensus_identity(jhum), JM.consensus_identity(jmouse))
    assert 0.0 < im < ih <= 1.0
    for seq, heavy in ((VH, True), (L1, False), (LAMBDA, False)):
        a, ja = M.GridChain(seq, heavy), JM.GridChain(seq, heavy)
        assert M.germline_identity(a) == JM.germline_identity(ja)
        assert M.consensus_identity(a) == JM.consensus_identity(ja)


def test_unalignable_raises():
    for mod in (M, JM):
        with pytest.raises(ValueError):
            mod.GridChain('ZZZZZZ', heavy=True, chain_hint='H')


def test_groups_and_positions_match_jax():
    human = [EXPERIMENTAL[n] for n in MOUSE]
    mouse = list(MOUSE.values())
    assert M.group_preservation(human, mouse) == JM.group_preservation(human, mouse)
    for vernier in (False, True):
        assert (M.group_mutation_precision(human, mouse, human, vernier)
                == JM.group_mutation_precision(human, mouse, human, vernier))
    for name in 'ABC':
        for k, heavy in ((0, True), (1, False)):
            seq, pred_seq = MOUSE[name][k], EXPERIMENTAL[name][k]
            par, pred = M.GridChain(seq, heavy), M.GridChain(pred_seq, heavy)
            jpar, jpred = JM.GridChain(seq, heavy), JM.GridChain(pred_seq, heavy)
            assert M.collect_positions(par, pred, name) == JM.collect_positions(jpar, jpred, name)
    for args in (('A', 'A', 'A'), ('A', 'A', 'B'), ('A', 'B', 'B'), ('A', 'B', 'C')):
        assert M.annotate_conservation(*args) == JM.annotate_conservation(*args)


# -- pairing and the reports (tests/test_harness_pairing.py) ---------------------

def test_parental_key():
    for name in ('3A3human_sample', 'plain', 'human_sample'):
        assert H._parental_key(name) == JH._parental_key(name)
    assert H._parental_key('3A3human_sample') == '3A3'


def _group_rows(mouse, exp, cols):
    frames = [pd.DataFrame(mouse, columns=cols), pd.DataFrame(exp, columns=cols)]
    return [dict(zip(cols, r)) for r in mouse], [dict(zip(cols, r)) for r in exp], frames


def test_exp_by_mouse_name_uses_order_name():
    cols = ['type', 'name', 'order_name', 'h_seq', 'l_seq']
    mouse = [('mouse', 'A', '0_mouse', 'MH_A', 'ML_A'), ('mouse', 'B', '1_mouse', 'MH_B', 'ML_B')]
    exp = [('humanized', 'hB-1', '1_humanized', 'EH_B', 'EL_B'),
           ('humanized', 'hA-9', '0_humanized', 'EH_A', 'EL_A')]
    m, e, frames = _group_rows(mouse, exp, cols)
    out, mode = H._exp_by_mouse_name(m, e, cols)
    assert (out, mode) == JH._exp_by_mouse_name(*frames)
    assert mode == 'order_name' and out['A'] == ('EH_A', 'EL_A') and out['B'] == ('EH_B', 'EL_B')


def test_exp_by_mouse_name_shared_name_pairing():
    cols = ['type', 'name', 'h_seq', 'l_seq']
    mouse = [('mouse', 'A', 'MH_A', 'ML_A'), ('mouse', 'B', 'MH_B', 'ML_B')]
    exp = [('humanized', 'B', 'EH_B', 'EL_B'), ('humanized', 'A', 'EH_A', 'EL_A')]
    m, e, frames = _group_rows(mouse, exp, cols)
    out, mode = H._exp_by_mouse_name(m, e, cols)
    assert (out, mode) == JH._exp_by_mouse_name(*frames)
    assert mode == 'name' and out['A'] == ('EH_A', 'EL_A')


def test_exp_by_mouse_name_positional_fallback_warns():
    cols = ['type', 'name', 'h_seq', 'l_seq']
    mouse = [('mouse', 'A', 'MH_A', 'ML_A'), ('mouse', 'B', 'MH_B', 'ML_B')]
    exp = [('humanized', 'hA', 'EH_A', 'EL_A'), ('humanized', 'hB', 'EH_B', 'EL_B')]
    m, e, frames = _group_rows(mouse, exp, cols)
    with pytest.warns(UserWarning, match='POSITIONAL'):
        out, mode = H._exp_by_mouse_name(m, e, cols)
    with pytest.warns(UserWarning, match='POSITIONAL'):
        assert (out, mode) == JH._exp_by_mouse_name(*frames)
    assert mode == 'positional' and out['A'] == ('EH_A', 'EL_A')


def test_putative_layout_maps_through_eval_ab(tmp_path):
    """Shared names, no order_name: every sample echoes its experimental
    pair, so every sample FR mutation is an experimental one."""
    pair = _pair_csv(tmp_path / 'pairs.csv', layout='name')
    sample = _sample_csv(tmp_path / 's.csv', [(f'{n}human_sample', *EXPERIMENTAL[n])
                                             for n in 'ABCD'])
    report = H.eval_ab(sample, pair, device='cpu')
    _assert_reports_match(report, JH.eval_ab(sample, pair))
    assert report['pairing'] == 'name' and report['n_matched'] == 4
    assert report['n_skipped_unmatched'] == 0
    assert report['fr_mutation_precision_h'] == pytest.approx(1.0)
    assert report['fr_mutation_precision_l'] == pytest.approx(1.0)


def test_eval_ab_name_pairing_multi_sample(tmp_path):
    """3 antibodies x 2 samples each, rows shuffled, one unknown name, one
    sample that does not align: the port's report is JAX's, and every
    aggregate equals the per-name value."""
    pair = _pair_csv(tmp_path / 'pairs.csv')
    (ma, ea), (mb, eb), (mc, ec) = [(MOUSE[n], EXPERIMENTAL[n]) for n in 'ABC']
    rows = [('Chuman_sample', *ec), ('Ahuman_sample', *ma), ('Bhuman_sample', *eb),
            ('ZZZUNKNOWNhuman_sample', *ma), ('Ahuman_sample', *ma),
            ('Chuman_sample', *mc), ('Bhuman_sample', *eb), ('Dhuman_sample', 'AAAA', 'GGGG')]
    sample = _sample_csv(tmp_path / 's.csv', rows)
    report = H.eval_ab(sample, pair, device='cpu')
    _assert_reports_match(report, JH.eval_ab(sample, pair))
    assert report['n_samples'] == 8 and report['n_matched'] == 6
    assert report['n_skipped_unmatched'] == 1 and report['n_skipped_unaligned'] == 1

    def pres_h(s_pair, m_pair):
        return M.all_preservation(M.GridChain(s_pair[0], True, 'H'),
                                  M.GridChain(m_pair[0], True, 'H'))

    expected_h = np.mean([pres_h(ec, mc), pres_h(ma, ma), pres_h(eb, mb),
                          pres_h(ma, ma), pres_h(mc, mc), pres_h(eb, mb)])
    assert report['preservation_all_h'] == pytest.approx(expected_h, abs=1e-9)
    assert pres_h(ma, ma) == 1.0 and pres_h(eb, mb) < 1.0
    assert report['fr_mutation_precision_h'] == pytest.approx(1.0)
    assert 0.0 < report['exp_preservation_all_h'] < 1.0


def test_eval_ab_order_independence(tmp_path):
    pair = _pair_csv(tmp_path / 'pairs.csv')
    rows = [(f'{n}human_sample', *EXPERIMENTAL[n]) for n in 'ABCD']
    ra = H.eval_ab(_sample_csv(tmp_path / 'a.csv', rows), pair, device='cpu')
    rb = H.eval_ab(_sample_csv(tmp_path / 'b.csv', rows[::-1]), pair, device='cpu')
    _assert_reports_match(ra, JH.eval_ab(str(tmp_path / 'a.csv'), pair))
    for k in ('preservation_all_h', 'preservation_all_l', 'fr_mutation_precision_h',
              'vernier_mutation_precision_l', 'consensus_fr_identity_h'):
        if ra[k] is None:
            assert rb[k] is None, k
        else:
            assert ra[k] == pytest.approx(rb[k], abs=1e-12), k


def test_eval_nano_name_pairing(tmp_path):
    rows = [('camel', 'v0', VHH), ('camel', 'v1', VHH[:50] + 'A' + VHH[51:]),
            ('humanization', 'v1human_sample', VHH[:50] + 'A' + VHH[51:]),
            ('humanization', 'v0human_sample', VHH),
            ('humanization', 'ghosthuman_sample', VHH)]
    path = _write(tmp_path / 's.csv', ['Specific', 'name', 'vhh_seq'], rows)
    report = H.eval_nano(path, device='cpu')
    _assert_reports_match(report, JH.eval_nano(path))
    assert report['n_samples'] == 3 and report['n_matched'] == 2
    assert report['preservation_all'] == pytest.approx(1.0)


def test_eval_ab_plots_battery(tmp_path):
    pair = _pair_csv(tmp_path / 'pairs.csv')
    sample = _sample_csv(tmp_path / 's.csv', [(f'{n}human_sample', *EXPERIMENTAL[n])
                                             for n in 'ABC'])
    plots, jplots = tmp_path / 'figs', tmp_path / 'jfigs'
    report = H.eval_ab(sample, pair, plots_dir=str(plots), device='cpu')
    _assert_reports_match(report, JH.eval_ab(sample, pair, plots_dir=str(jplots)))
    for f in ('preservation_dist.png', 'overlap_mean.png', 'overlap_venns.png',
              'conservation_positions.csv'):
        assert os.path.getsize(plots / f) > 0, f
    assert 'overlap_shared_mean' in report
    assert ((plots / 'conservation_positions.csv').read_text()
            == (jplots / 'conservation_positions.csv').read_text())
    with open(plots / 'conservation_positions.csv', newline='') as f:
        cons = list(csv.DictReader(f))
    assert {r['conservation'] for r in cons} <= {'Conserved', 'Back-mutated', 'Humanized',
                                                 'Engineered'}
    assert {r['chain'] for r in cons} == {'Heavy', 'Light'}


def test_eval_ab_humab25_layout(tmp_path):
    """Mouse and experimental pairs in separate CSVs, paired by name through
    --experimental-csv (a Raw_name column)."""
    mouse = _write(tmp_path / 'parental_mouse.csv', ['name', 'h_seq', 'l_seq'],
                   [(n, *MOUSE[n]) for n in 'ABCD'])
    exp = _write(tmp_path / 'exp.csv', ['Raw_name', 'h_score', 'h_seq', 'l_seq'],
                 [(n, 80.0, *EXPERIMENTAL[n]) for n in 'ABCD'])
    sample = _sample_csv(tmp_path / 's.csv', [(f'{n}human_sample', *EXPERIMENTAL[n])
                                             for n in 'ABCD'])
    report = H.eval_ab(sample, mouse, experimental_csv=exp, device='cpu')
    _assert_reports_match(report, JH.eval_ab(sample, mouse, experimental_csv=exp))
    assert report['pairing'] == 'experimental_csv' and report['n_matched'] == 4
    assert report['fr_mutation_precision_h'] == pytest.approx(1.0)
    assert report['fr_mutation_precision_l'] == pytest.approx(1.0)
    assert 0.5 < report['preservation_all_h'] < 1.0


# -- AbNatiV through the harness ---------------------------------------------------

@pytest.fixture(scope='module')
def scorers(tmp_path_factory):
    """Smoke-hparams scorers (random weights from seeds) written in the
    reference layout that both packages read."""
    root = tmp_path_factory.mktemp('scorers')
    return {t: FT.save_abnativ(str(root / f'{t}.ckpt'),
                               FT.load_abnativ(None, False, seed=i, device='cpu'))
            for i, t in enumerate(('VH', 'VKappa', 'VLambda', 'VHH'))}


@pytest.mark.parametrize('model_type', ['VH', 'VKappa', 'VLambda', 'VHH'])
def test_abnativ_scores_local_matches_jax(scorers, model_type):
    seqs = [H1, L1, H2, L2, LAMBDA, VHH, VH_HUM, 'ZZZZ', ''] * 8
    got = H.abnativ_scores_local(seqs, model_type, scorers[model_type], batch_size=16,
                                 device='cpu')
    want = JH.abnativ_scores_local(seqs, model_type, scorers[model_type], batch_size=16)
    assert len(got) == len(seqs)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, equal_nan=True)
    assert np.isnan(got[7]) and np.isfinite(got[0])
    # a sequence's score does not depend on its batch
    alone = H.abnativ_scores_local(seqs[:3], model_type, scorers[model_type],
                                   batch_size=16, device='cpu')
    assert alone == got[:3]


def test_eval_reports_with_scorers_match_jax(tmp_path, scorers):
    pair = _pair_csv(tmp_path / 'pairs.csv')
    rows = [(f'{n}human_sample', *EXPERIMENTAL[n]) for n in 'ABCDE'] + [
        ('Ahuman_sample', *MOUSE['A']), ('Chuman_sample', *MOUSE['C'])]
    sample = _sample_csv(tmp_path / 's.csv', rows)
    kw = dict(abnativ_vh=scorers['VH'], abnativ_vlk=scorers['VKappa'],
              abnativ_vll=scorers['VLambda'])
    report = H.eval_ab(sample, pair, device='cpu', **kw)
    _assert_reports_match(report, JH.eval_ab(sample, pair, **kw))
    assert np.isfinite(report['abnativ_vl_improvement'])
    nano = _write(tmp_path / 'n.csv', ['Specific', 'name', 'vhh_seq'],
                  [('camel', 'v0', VHH), ('humanization', 'v0human_sample', VHH),
                   ('humanization', 'v0human_sample', VH_HUM)])
    kw = dict(abnativ_vh=scorers['VH'], abnativ_vhh=scorers['VHH'])
    report = H.eval_nano(nano, device='cpu', **kw)
    _assert_reports_match(report, JH.eval_nano(nano, **kw))
    assert report['abnativ_vhh_delta'] == pytest.approx(
        report['abnativ_vhh_mean'] - C.NANO_EVAL_REF_VHH_SCORE)
    assert C.NANO_EVAL_REF_VHH_SCORE == JC.NANO_EVAL_REF_VHH_SCORE


def test_harness_cli_and_the_card_default(tmp_path, scorers, capsys):
    pair = _pair_csv(tmp_path / 'pairs.csv')
    sample = _sample_csv(tmp_path / 's.csv', [('Ahuman_sample', *EXPERIMENTAL['A'])])
    out = str(tmp_path / 'r.json')
    report = H.main(['ab', '--sample-csv', sample, '--pair-csv', pair, '--abnativ-vh',
                     scorers['VH'], '--out', out, '--device', 'cpu'])
    import json
    assert json.loads(capsys.readouterr().out) == report == json.load(open(out))
    _assert_reports_match(report, JH.eval_ab(sample, pair, abnativ_vh=scorers['VH']))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            H.abnativ_scores_local([H1], 'VH', scorers['VH'])


# -- plots (tests/test_plots.py) ----------------------------------------------------

class FakeChain:
    def __init__(self, grid):
        self.grid = np.asarray(list(grid))

    def occupied(self):
        return self.grid != '-'


def test_mutation_overlap_counts():
    args = FakeChain('AAAAAA--'), FakeChain('ACADAA--'), FakeChain('ACAEAF--')
    o = P.mutation_overlap(*args)
    assert o == JP.mutation_overlap(*args) == {'Baseline only': 1, 'Shared': 1,
                                               'Predicted only': 2}


def test_mutation_overlap_no_mutations():
    a = FakeChain('AAAA')
    assert P.mutation_overlap(a, FakeChain('AAAA'), FakeChain('AAAA')) == {
        'Baseline only': 0, 'Shared': 0, 'Predicted only': 0}


def test_venn2_layout_lens_area_matches_shared():
    for a_only, shared, b_only in [(5, 3, 7), (1, 1, 1), (10, 0.5, 2)]:
        r1, r2, d = P._venn2_layout(a_only, shared, b_only)
        assert (r1, r2, d) == JP._venn2_layout(a_only, shared, b_only)
        assert abs(np.pi * r1 * r1 - (a_only + shared)) < 1e-6
        assert abs(np.pi * r2 * r2 - (b_only + shared)) < 1e-6
        assert abs(P._lens_area(d, r1, r2) - shared) < 1e-4


def test_venn2_layout_disjoint():
    r1, r2, d = P._venn2_layout(4, 0, 9)
    assert d > r1 + r2 and (r1, r2, d) == JP._venn2_layout(4, 0, 9)


@pytest.fixture()
def overlap_rows():
    rng = np.random.RandomState(0)
    return [{'Baseline only': int(rng.randint(1, 10)), 'Shared': int(rng.randint(0, 8)),
             'Predicted only': int(rng.randint(1, 10)), 'name': f'ab{i}'} for i in range(6)]


def test_plot_overlap_writes_file(tmp_path, overlap_rows):
    out = str(tmp_path / 'overlap.png')
    P.plot_overlap(overlap_rows, out)
    assert os.path.getsize(out) > 0


def test_plot_overlap_venns_writes_file(tmp_path, overlap_rows):
    out = str(tmp_path / 'venns.png')
    P.plot_overlap_venns(overlap_rows, out, ncols=4)
    assert os.path.getsize(out) > 0


@pytest.fixture()
def oasis_curves_df():
    rng = np.random.RandomState(1)
    cols = ['0%'] + [f'{p}%' for p in range(1, 91)]
    rows = []
    for g in ('HuDiff', 'Mouse', 'Experimental'):
        base = {'HuDiff': 0.85, 'Mouse': 0.45, 'Experimental': 0.8}[g]
        for _ in range(4):
            vals = np.clip(base - np.linspace(0, 0.3, len(cols))
                           + rng.normal(0, 0.01, len(cols)), 0, 1)
            rows.append(dict({'group': g}, **dict(zip(cols, vals))))
    return pd.DataFrame(rows, index=[f'ab{i}' for i in range(12)])


def test_plot_oasis_curves(tmp_path, oasis_curves_df):
    out = str(tmp_path / 'curves.png')
    P.plot_oasis_curves(oasis_curves_df, out, groupby='group')
    assert os.path.getsize(out) > 0


def test_plot_oasis_curves_ungrouped(tmp_path, oasis_curves_df):
    out = str(tmp_path / 'curves2.png')
    P.plot_oasis_curves(oasis_curves_df.drop(columns=['group']).iloc[:3], out)
    assert os.path.getsize(out) > 0


def test_plot_oasis_curve_and_barplots(tmp_path, oasis_curves_df):
    out = str(tmp_path / 'panel.png')
    P.plot_oasis_curve_and_barplots(oasis_curves_df, 'group', out)
    assert os.path.getsize(out) > 0


def test_load_oasis_curves_csv(tmp_path, oasis_curves_df):
    path = str(tmp_path / 'curves.csv')
    oasis_curves_df.to_csv(path)
    df = P.load_oasis_curves(path)
    assert '50%' in df.columns and len(df) == len(oasis_curves_df)
    pd.testing.assert_frame_equal(df, JP.load_oasis_curves(path))


def test_overlap_table_on_real_grids():
    h_exp = H2[:30] + 'V' + H2[31:]
    h_pred = H2[:30] + 'V' + H2[31:50] + 'T' + H2[51:]
    args = ([(H2, L2)], [(h_exp, L2)], [(h_pred, L2)])
    rows = P.overlap_table(*args, names=['x'])
    assert rows == JP.overlap_table(*args, names=['x'])
    assert len(rows) == 1 and rows[0]['Shared'] >= 1 and rows[0]['name'] == 'x'


def test_plots_raise_without_matplotlib(monkeypatch, overlap_rows):
    """The figures need matplotlib; the venn geometry and overlap_table do
    not."""
    import builtins
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith('matplotlib'):
            raise ImportError(name)
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, '__import__', no_matplotlib)
    with pytest.raises(RuntimeError, match='matplotlib not available'):
        P.plot_overlap(overlap_rows, 'unused.png')
    assert P._venn2_layout(5, 3, 7) == JP._venn2_layout(5, 3, 7)
    assert P.overlap_table([(H2, L2)], [(H2, L2)], [(H2, L2)])[0]['Shared'] == 0


# -- web evaluators with injected responses (tests/test_web_eval.py) ----------------

WEB_VH = ('QVQLKQSGPGLVAPSQSLSITCTVSGFSLINYAISWVRQPPGKGLEWLGVIWTGGGTNYNSALKSRLSI'
          'SKDNSKSQVFLKMNSLQTDDTARYYCARKDYYGRYYGMDYWGQGTSVTVS')
T20_HTML = ('<html><body><table><tr><td>T20 Score:</td><td>82.51</td></tr>'
            '</table></body></html>')
ZSCORE_HTML = '<html><h3>The Z-score value of the Query sequence is: -0.417</h3></html>'
HUMAB_HTML = """
<html><body>
<table class="table table-results">
  <tr><th>V Gene</th><th>Score</th><th>Threshold</th><th>Class</th></tr>
  <tr><td>hv1</td><td>0.42</td><td>0.85</td><td>MOUSE</td></tr>
  <tr><td>hv3</td><td>0.91</td><td>0.85</td><td>HUMAN</td></tr>
</table>
<table class="table table-results">
  <tr><td>kv1</td><td>0.88</td><td>0.80</td><td>HUMAN</td></tr>
</table>
<table class="table table-results">
  <tr><td>ignored third table</td><td>HUMAN</td></tr>
</table>
</body></html>
"""


@pytest.fixture
def no_sleep(monkeypatch):
    sleeps = []
    for mod in (web, jweb):
        monkeypatch.setattr(mod, 'SLEEP', sleeps.append)
    return sleeps


def _fake_fetch(monkeypatch, responder, mods=(web,)):
    calls = []

    def fetch(url, method='get', data=None, timeout=60.0):
        calls.append({'url': url, 'method': method, 'data': data})
        return responder(url, method, data)

    for mod in mods:
        monkeypatch.setattr(mod, 'FETCH', fetch)
    return calls


def test_t20_url_params_and_regex(monkeypatch, no_sleep):
    calls = _fake_fetch(monkeypatch, lambda u, m, d: web.Response(True, T20_HTML, u))
    monkeypatch.setattr(web, '_chain_type', lambda s: 'K')
    assert web.get_t20_online('PEPTIDESEQ', region=1) == (82.51, 'vk')
    assert calls[0]['url'] == ('https://sam.curiaglobal.com/t20/cgi-bin/'
                               'blast.py?chain=vk&region=1&output=3&seqs=PEPTIDESEQ')
    assert calls[0]['method'] == 'get' and web.T20_URL == jweb.T20_URL


def test_t20_region2_forces_vh(monkeypatch, no_sleep):
    calls = _fake_fetch(monkeypatch, lambda u, m, d: web.Response(True, T20_HTML, u))
    _, chain_type = web.get_t20_online('PEPTIDESEQ', region=2)
    assert chain_type == 'vh' and 'chain=vh&region=2' in calls[0]['url']
    with pytest.raises(ValueError):
        web.get_t20_online('PEPTIDESEQ', region=3)


def test_t20_retries_then_succeeds(monkeypatch, no_sleep):
    n = {'i': 0}

    def responder(u, m, d):
        n['i'] += 1
        if n['i'] < 3:
            return web.Response(False, 'server busy', u, 503)
        return web.Response(True, T20_HTML, u)

    calls = _fake_fetch(monkeypatch, responder)
    monkeypatch.setattr(web, '_chain_type', lambda s: 'H')
    assert web.get_t20_online('SEQ') == (82.51, 'vh')
    assert len(calls) == 3 and no_sleep[:2] == [0.5, 5.5]


def test_t20_unparseable_returns_none(monkeypatch, no_sleep):
    _fake_fetch(monkeypatch, lambda u, m, d: web.Response(True, '<html>error</html>', u))
    monkeypatch.setattr(web, '_chain_type', lambda s: 'H')
    assert web.get_t20_online('SEQ') == (None, None)


def test_t20_csv_columns_match_jax(monkeypatch, no_sleep, tmp_path):
    """The port writes the CSV with ``csv``: the same rows as the JAX
    package's pandas writer, on the same canned responses."""
    _fake_fetch(monkeypatch, lambda u, m, d: web.Response(True, T20_HTML, u), (web, jweb))
    chain_type = lambda s: 'H' if s.startswith('HHH') else 'K'  # noqa: E731
    monkeypatch.setattr(web, '_chain_type', chain_type)
    monkeypatch.setattr(jweb, '_chain_type', chain_type)
    text = ('Specific,name,hseq,lseq,\nmouse,ab1,HHHAAA,KKKBBB\n'
            'humanization,ab1human_sample,HHHCCC,KKKDDD\n')
    for d in ('port', 'jax'):
        (tmp_path / d).mkdir()
        (tmp_path / d / 'sample.csv').write_text(text)
    out = web.t20_csv(str(tmp_path / 'port' / 'sample.csv'))
    jout = jweb.t20_csv(str(tmp_path / 'jax' / 'sample.csv'))
    df = pd.read_csv(out)
    assert list(df.columns) == ['Raw_name', 'h_score', 'h_gene', 'l_score', 'l_gene',
                                'h_seq', 'l_seq']
    assert len(df) == 1 and df.iloc[0]['h_score'] == 82.51
    assert df.iloc[0]['h_gene'] == 'vh' and df.iloc[0]['l_gene'] == 'vk'
    pd.testing.assert_frame_equal(df, pd.read_csv(jout))
    frame = web.t20_frame_csv(str(tmp_path / 'port' / 'sample.csv'))
    pd.testing.assert_frame_equal(pd.read_csv(frame), pd.read_csv(
        jweb.t20_frame_csv(str(tmp_path / 'jax' / 'sample.csv'))))


@pytest.mark.parametrize('group,db', [('H', 'human_heavy'), ('K', 'human_kappa'),
                                      ('L', 'human_lambda')])
def test_zscore_db_selection_and_regex(monkeypatch, no_sleep, group, db):
    calls = _fake_fetch(monkeypatch, lambda u, m, d: web.Response(True, ZSCORE_HTML, u))
    monkeypatch.setattr(web, '_chain_type', lambda s: group)
    assert web.get_z_score_online('MYSEQ') == (-0.417, db)
    assert calls[0]['url'] == ('http://www.bioinf.org.uk/abs/shab/'
                               f'shab.cgi?aa_sequence=MYSEQ&DB={db}')


def test_humab_job_flow(monkeypatch, no_sleep):
    def responder(url, method, data):
        if method == 'post':
            return web.Response(True, '', url + '/result/job42')
        return web.Response(True, HUMAB_HTML, url)

    calls = _fake_fetch(monkeypatch, responder)
    out = web.humab_scores('HSEQ', 'LSEQ', job_name='test_0')
    post = calls[0]
    assert post['method'] == 'post' and post['url'] == web.HUMAB_URL == jweb.HUMAB_URL
    assert post['data'] == {'h_sequence_score': 'HSEQ', 'l_sequence_score': 'LSEQ',
                            'jobname_score': 'test_0', 'humanise': True}
    assert no_sleep == [web.HUMAB_WAIT_SECONDS]
    assert calls[1]['url'].endswith('/result/job42')
    assert out['h_v_gene'] == 'hv3' and out['h_score'] == 0.91
    assert out['h_classification'] == 'HUMAN'
    assert out['l_v_gene'] == 'kv1' and out['l_score'] == 0.88


def test_humab_table_parser_only_first_two_tables():
    rows = web.extract_human_rows(HUMAB_HTML)
    assert rows == jweb.extract_human_rows(HUMAB_HTML)
    assert len(rows) == 2 and rows[0][-1] == 'HUMAN' and rows[0][0] == 'hv3'
    assert rows[1][0] == 'kv1'


def test_humab_result_row_shape(monkeypatch, no_sleep):
    def responder(url, method, data):
        if method == 'post':
            return web.Response(True, '', url + '?job=1')
        return web.Response(True, HUMAB_HTML, url)

    _fake_fetch(monkeypatch, responder)
    data = web.get_humab_result('j', 'HSEQ', 'LSEQ')
    assert len(data) == 10 and data[-2:] == ['HSEQ', 'LSEQ']


def test_chain_type_detects_heavy():
    for seq in (WEB_VH, L1, LAMBDA):
        assert web._chain_type(seq) == jweb._chain_type(seq)
    assert web._chain_type(WEB_VH) == 'H'


def test_fail_soft_without_network(monkeypatch, no_sleep):
    def responder(u, m, d):
        raise web.WebEvalUnavailable('no egress')

    _fake_fetch(monkeypatch, responder)
    monkeypatch.setattr(web, '_chain_type', lambda s: 'H')
    with pytest.raises(web.WebEvalUnavailable):
        web.get_t20_online('SEQ', retries=2)
    with pytest.raises(web.WebEvalUnavailable):
        web.get_z_score_online('SEQ', retries=2)
