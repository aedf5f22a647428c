"""The port's OAS loader (hudiff_tpu_torch/data/{store,oas}.py,
factories.py) against the JAX package's, on the CPU, on files written
here; and ``pretrain --data`` on a store written here.

- The record store: written by each package, read by the other (the JAX
  reader on both its paths).
- ``parse_cgz_file`` and both ``build_*_from_csv`` read the same files as
  JAX's, which read them with pandas: the same records and splits, the
  same rows dropped (a wrong locus, 'X', a sequence not in its alignment,
  unreadable numbering, duplicates, fragments, swapped columns), nothing
  from a truncated gzip, and a missing 'type' column refused.
- The datasets' persisted splits, ``pair_batch``, ``heavy_batch``
  (``drop_aho_failed``), ``batch_iterator``, ``n_batches_per_epoch`` and
  ``get_dataset`` equal; the factories.
"""
import glob
import gzip
import json
import os
import pickle
import shutil

import numpy as np
import pytest
import torch

from hudiff_tpu import factories as JFAC
from hudiff_tpu.data import oas as JO
from hudiff_tpu.data import store as JS
from hudiff_tpu.training import schedules as JSCH
from hudiff_tpu.utils.config import Namespace as JNamespace
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch import factories as FAC
from hudiff_tpu_torch.data import oas as O
from hudiff_tpu_torch.data import store as S
from hudiff_tpu_torch.models.denoiser import AntiTFNet, NanoAntiTFNet
from hudiff_tpu_torch.models.finetune import AbFinetuneConfig, NanoFinetuneConfig
from hudiff_tpu_torch.numbering import imgt as IMGT
from hudiff_tpu_torch.training import pretrain as PT
from hudiff_tpu_torch.training import schedules as SCH
from hudiff_tpu_torch.utils.config import Namespace, load_yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
H2 = ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYAMSWVRQAPGKGLEWVSAISGSGGSTYY'
      'ADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAKDRGYYFDYWGQGTLVTVSS')
L2 = ('QSVLTQPPSASGTPGQRVTISCSGSSSNIGSNTVNWYQQLPGTAPKLLIYSNNQRPSGVP'
      'DRFSGSKSGTSASLAISGLQSEDEADYYCAAWDDSLNGPVFGGGTKLTVL')
VHH = ('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADSVKGRF'
       'TISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test (several xdist workers share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the record store -------------------------------------------------------------

@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, writer):
    path = str(tmp_path / 'store')
    recs = [{'i': i, 'payload': 'x' * i, 'arr': np.arange(i)} for i in range(13)]
    with (S if writer == 'port' else JS).RecordStoreWriter(path) as w:
        for r in recs:
            w.put_obj(r)
    assert S.exists(path) and JS.exists(path)
    readers = [S.RecordStore(path), JS.RecordStore(path, native=False),
               JS.RecordStore(path, native=True)]
    for rd in readers:
        assert len(rd) == len(recs)
        for got, want in zip(rd, recs):
            assert got['i'] == want['i'] and got['payload'] == want['payload']
            np.testing.assert_array_equal(got['arr'], want['arr'])
    assert all(readers[0].get(i) == rd.get(i) for rd in readers[1:] for i in range(13))
    for rd in readers:
        rd.close()
    with open(path + '.idx', 'r+b') as f:
        f.write(b'NOTASTOR')
    with pytest.raises(ValueError, match='not a RecordStore'):
        S.RecordStore(path)


# -- OAS exports -------------------------------------------------------------------

def _anarci_json(seq, heavy, locus):
    """Segmented ANARCI-style numbering (str(dict), as OAS embeds it)."""
    placed = IMGT.grid_string(seq, heavy=heavy, chain_hint=locus)
    positions = C.HEAVY_POSITIONS if heavy else C.LIGHT_POSITIONS
    regions = C.HEAVY_REGION_INDEX if heavy else C.LIGHT_REGION_INDEX
    segs = {name: {} for name in C.SEG_NAMES[locus]}
    for i, ch in enumerate(placed['grid']):
        if ch != '-':
            segs[C.SEG_NAMES[locus][regions[i]]][positions[i] + ' '] = ch
    return str(segs)


COLS = ['locus_heavy', 'locus_light', 'ANARCI_numbering_heavy', 'ANARCI_numbering_light',
        'sequence_alignment_aa_heavy', 'sequence_alignment_aa_light', 'extra']


def _write_cgz(path, rows):
    with gzip.open(path, 'wt') as f:
        f.write('"{""Run"": ""synthetic"", ""Species"": ""mouse""}"\n')   # metadata line
        f.write(','.join(COLS) + '\n')
        for r in rows:
            f.write(','.join('"%s"' % str(r.get(c, '')).replace('"', "'") for c in COLS)
                    + '\n')


def _cgz_rows():
    good_k = {'locus_heavy': 'H', 'locus_light': 'K',
              'ANARCI_numbering_heavy': _anarci_json(H1, True, 'H'),
              'ANARCI_numbering_light': _anarci_json(L1, False, 'K'),
              'sequence_alignment_aa_heavy': H1, 'sequence_alignment_aa_light': L1,
              'extra': 12}
    good_l = {'locus_heavy': 'H', 'locus_light': 'L',
              'ANARCI_numbering_heavy': _anarci_json(H2, True, 'H'),
              'ANARCI_numbering_light': _anarci_json(L2, False, 'L'),
              'sequence_alignment_aa_heavy': H2, 'sequence_alignment_aa_light': L2}
    x_h = H1[:30] + 'X' + H1[31:]
    with_x = dict(good_k, ANARCI_numbering_heavy=_anarci_json(x_h, True, 'H'),
                  sequence_alignment_aa_heavy=x_h)
    not_in = dict(good_l, sequence_alignment_aa_heavy=H1)
    broken = dict(good_l, ANARCI_numbering_light='{not json')
    swapped_light = dict(good_k, sequence_alignment_aa_light=L1[5:])
    return [good_k, dict(good_k, locus_heavy='K'), with_x, good_k, not_in, broken,
            dict(good_l, locus_light='H'), dict(good_l, locus_light=''), swapped_light,
            good_l]


@pytest.fixture()
def cgz_dir(tmp_path):
    root = tmp_path / 'oas'
    (root / 'new_cgz_data').mkdir(parents=True)
    rows = _cgz_rows()
    _write_cgz(root / 'new_cgz_data' / 'a.csv.gz', rows)
    _write_cgz(root / 'new_cgz_data' / 'b.csv.gz', rows[-1:] + rows[:1])   # repeats only
    return root


@pytest.mark.parametrize('mouse', [False, True])
def test_parse_cgz_file_matches_jax(cgz_dir, mouse):
    path = str(cgz_dir / 'new_cgz_data' / 'a.csv.gz')
    got, seen = O.parse_cgz_file(path, set(), mouse=mouse)
    ref, ref_seen = JO.parse_cgz_file(path, set(), mouse=mouse)
    assert got == ref and seen == ref_seen and len(got) == 2
    again, _ = O.parse_cgz_file(str(cgz_dir / 'new_cgz_data' / 'b.csv.gz'), seen, mouse=mouse)
    assert again == []


def test_parse_cgz_file_truncated_gzip(tmp_path):
    path = tmp_path / 't.csv.gz'
    _write_cgz(path, _cgz_rows() * 20)
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    seen = {('a', 'b')}
    assert O.parse_cgz_file(str(path), seen) == JO.parse_cgz_file(str(path), set(seen)) \
        == ([], {('a', 'b')})


@pytest.mark.parametrize('mouse', [False, True])
def test_pair_dataset_split_and_batches_match_jax(cgz_dir, tmp_path, mouse):
    """The same OAS root built by each package: the same records, the same
    persisted split; the store each wrote reads in the other."""
    jroot = tmp_path / 'jax_oas'
    shutil.copytree(cgz_dir, jroot)
    ds = O.OasPairDataset(str(cgz_dir), mouse=mouse, split_ratio=0.5)
    jds = JO.OasPairDataset(str(jroot), mouse=mouse, split_ratio=0.5)
    assert len(ds) == len(jds) == 2
    assert [ds[i] for i in range(len(ds))] == [jds[i] for i in range(len(jds))]
    for k in ('train', 'val'):
        np.testing.assert_array_equal(ds.splits[k], jds.splits[k])
    cross = JO.OasPairDataset(str(cgz_dir), mouse=mouse)   # the port's files, JAX's reader
    assert [cross[i] for i in range(2)] == [ds[i] for i in range(2)]
    recs = [ds[i] for i in range(2)]
    for k, v in O.pair_batch(recs, with_aho=mouse).items():
        np.testing.assert_array_equal(v, JO.pair_batch(recs, with_aho=mouse)[k])


def _hl_csv(path, rows, cols=('name', 'h_seq', 'l_seq', 'type')):
    with open(path, 'w') as f:
        f.write(','.join(cols) + '\n')
        for r in rows:
            f.write(','.join(r[:len(cols)]) + '\n')


@pytest.mark.parametrize('type_filter', [None, 'humanized'])
def test_build_pair_dataset_from_csv_matches_jax(tmp_path, type_filter):
    rows = [('ab1', H1, L1, 'humanized'), ('ab2', H2, L2, 'mouse'),
            ('dup', H1, L1, 'humanized'), ('frag', H1[:20], L1, 'humanized'),
            ('swap', L1, H1, 'humanized'), ('ab3', H2, L1, 'humanized'), ('', H1, L2, '')]
    csv_path = str(tmp_path / 'pairs.csv')
    _hl_csv(csv_path, rows)
    out = O.build_pair_dataset_from_csv(csv_path, str(tmp_path / 'port'),
                                        type_filter=type_filter, split_ratio=0.6)
    jout = JO.build_pair_dataset_from_csv(csv_path, str(tmp_path / 'jax'),
                                          type_filter=type_filter, split_ratio=0.6)
    ds, jds = O.OasPairDataset(out), JO.OasPairDataset(jout)
    assert len(ds) == len(jds) == (4 if type_filter is None else 2)
    assert [ds[i] for i in range(len(ds))] == [jds[i] for i in range(len(jds))]
    for k in ('train', 'val'):
        np.testing.assert_array_equal(ds.splits[k], jds.splits[k])
    _hl_csv(str(tmp_path / 'untyped.csv'), rows, cols=('name', 'h_seq', 'l_seq'))
    with pytest.raises(ValueError, match="no 'type' column"):
        O.build_pair_dataset_from_csv(str(tmp_path / 'untyped.csv'), str(tmp_path / 'u'),
                                      type_filter='humanized')


@pytest.mark.parametrize('column', ['vhhseq', 'sequence'])
def test_build_vhh_dataset_from_csv_matches_jax(tmp_path, column):
    csv_path = str(tmp_path / 'vhh.csv')
    with open(csv_path, 'w') as f:
        f.write(f'id,{column}\n1,{VHH}\n2,{H2}\n3,{L1}\n4,{VHH[10:]}\n')
    got = O.build_vhh_dataset_from_csv(csv_path, str(tmp_path / 'port'))
    ref = JO.build_vhh_dataset_from_csv(csv_path, str(tmp_path / 'jax'))
    with open(got, 'rb') as f, open(ref, 'rb') as g:
        lines, jlines = pickle.load(f), pickle.load(g)
    assert lines == jlines and len(lines) >= 2


def _heavy_pickle(path, n=23, failed=(3, 7)):
    """(name, seq, pad_seq, chain, aho_seq) tuples; ``failed`` rows have an
    AHo alignment ending in '---'."""
    grid = IMGT.grid_string(VHH, heavy=True, chain_hint='VHH')
    lines = []
    rs = np.random.RandomState(0)
    for i in range(n):
        pad = ''.join(c if c == '-' or rs.rand() > 0.2 else C.AA_1[rs.randint(20)]
                      for c in grid['grid'])
        aho = grid['aho'][:-3] + '---' if i in failed else grid['aho']
        lines.append((f'h{i}', VHH, pad, 'H', aho, 'extra'))
    with open(path, 'wb') as f:
        pickle.dump(lines, f)
    return str(path)


def test_unpair_dataset_batches_and_iterator_match_jax(tmp_path):
    (tmp_path / 'p').mkdir()
    (tmp_path / 'j').mkdir()
    ds = O.OasUnpairDataset(_heavy_pickle(tmp_path / 'p' / 'vhh.pkl'), chaintype='vhh')
    jds = JO.OasUnpairDataset(_heavy_pickle(tmp_path / 'j' / 'vhh.pkl'), chaintype='vhh')
    assert len(ds) == len(jds) == 23
    for k in ('train', 'val'):
        np.testing.assert_array_equal(ds.splits[k], jds.splits[k])
    assert [ds[i] for i in range(23)] == [jds[i] for i in range(23)]

    def collate(mod):
        return lambda recs: mod.heavy_batch(recs, with_aho=True, drop_aho_failed=True)

    for split, bs, shuffle in (('train', 5, True), ('train', 40, True), ('val', 5, False)):
        it = O.batch_iterator(ds, ds.splits[split], bs, collate(O), seed=3, shuffle=shuffle)
        jit = JO.batch_iterator(jds, jds.splits[split], bs, collate(JO), seed=3,
                                shuffle=shuffle)
        n = O.n_batches_per_epoch(len(ds.splits[split]), bs)
        assert n == JO.n_batches_per_epoch(len(jds.splits[split]), bs)
        for _ in range(2 * n + 1):
            a, b = next(it), next(jit)
            for k in ('tokens', 'aho'):
                np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match='empty'):
        next(O.batch_iterator(ds, np.array([], int), 4, collate(O)))
    with pytest.raises(ValueError, match='empty'):
        O.n_batches_per_epoch(0, 4)


def test_get_dataset_and_factories_match_jax(cgz_dir, tmp_path):
    (tmp_path / 'p').mkdir()
    heavy = _heavy_pickle(tmp_path / 'p' / 'heavy.pkl')
    for name, root in (('pair', str(cgz_dir)), ('heavy', heavy), ('vhh', heavy)):
        ds, jds = FAC.get_dataset(root, name), JFAC.get_dataset(root, name)
        assert type(ds).__name__ == type(jds).__name__
        assert [ds[i] for i in range(len(ds))] == [jds[i] for i in range(len(jds))]
    with pytest.raises(NotImplementedError):
        FAC.get_dataset(heavy, 'nope')
    for cfg_name, cls in (('antibody_test.yml', AntiTFNet), ('heavy_test.yml', NanoAntiTFNet),
                          ('antibody_finetune.yml', AbFinetuneConfig),
                          ('nano_finetune.yml', NanoFinetuneConfig)):
        cfg = load_yaml(os.path.join(REPO, 'configs', cfg_name))
        got = FAC.model_selected(cfg)
        assert isinstance(got, cls)
        if not isinstance(got, torch.nn.Module):
            ref = JFAC.model_selected(JNamespace.wrap(cfg.to_dict()))
            assert got.__dict__ == ref.__dict__
    plateau = dict(type='plateau', factor=0.5, patience=1, min_lr=1e-6)
    a = FAC.scheduler_selected(Namespace.wrap(plateau), 1e-3)
    b = JFAC.scheduler_selected(JNamespace.wrap(plateau), 1e-3)
    assert [a.update(v) for v in (1, 2, 3, 0.5)] == [b.update(v) for v in (1, 2, 3, 0.5)]
    warm = dict(type='warm_up', max_lr=1e-3, min_lr=1e-6, warmup_steps=5, max_steps=20)
    a = FAC.scheduler_selected(Namespace.wrap(warm), 1e-5)
    b = JFAC.scheduler_selected(JNamespace.wrap(warm), 1e-5)
    assert [a(s) for s in range(0, 25, 4)] == pytest.approx([float(b(s))
                                                             for s in range(0, 25, 4)])
    cosine = FAC.scheduler_selected(Namespace.wrap({'type': 'cosine_annal', 'T_max': 4}), 1e-3)
    ref = JSCH.CosineAnnealing(init_lr=1e-3, t_max=4)
    assert isinstance(cosine, SCH.CosineAnnealing)
    assert [cosine.update(0) for _ in range(5)] == [ref.update(0) for _ in range(5)]
    opt = FAC.optimizer_selected(Namespace.wrap({'type': 'AdamW', 'lr': 1e-3}),
                                 [torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, torch.optim.AdamW)


# -- pretrain --data ---------------------------------------------------------------

def _pair_root(tmp_path):
    """An OAS root with ten distinct pairs (the two test antibodies with
    point mutations in FR1)."""
    rows = []
    for i in range(10):
        h = H1[:3] + 'ACDEFGHIKL'[i] + H1[4:]
        rows.append((f'ab{i}', h, L1 if i % 2 else L2, 'humanized'))
    _hl_csv(str(tmp_path / 'pairs.csv'), rows)
    return O.build_pair_dataset_from_csv(str(tmp_path / 'pairs.csv'), str(tmp_path / 'root'),
                                         split_ratio=0.5)


def _cli(logdir, config, data, *extra):
    cfg = load_yaml(os.path.join(REPO, 'configs', config)).to_dict()
    cfg['train'].update(batch_size=2, batch_acc=1)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, 'cfg.yml')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    PT.main(['--config', path, '--data', data, '--device', 'cpu', '--fp32', '--logdir',
             logdir, '--max-iter', '3', '--valid-step', '3', *extra])
    run = sorted(glob.glob(os.path.join(logdir, '*_pretrain*')))[-1]
    with open(os.path.join(run, 'metrics.jsonl')) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize('kind', ['pair', 'heavy'])
def test_pretrain_cli_reads_data(tmp_path, kind):
    """pretrain --data on a store written here: three iterations over the
    train split and one validation over the whole val split (pair: 5 of 10
    records at split 0.5, two batches of 2; heavy: 1 of 10 at the default
    0.95, one batch), on the batches ``data_batches`` yields."""
    if kind == 'pair':
        data, config = _pair_root(tmp_path), 'antibody_test.yml'
    else:
        (tmp_path / 'h').mkdir()
        data, config = _heavy_pickle(tmp_path / 'h' / 'heavy.pkl', n=10), 'heavy_test.yml'
    rows = _cli(str(tmp_path / 'logs'), config, data, '--kind', kind)
    assert [r['step'] for r in rows if 'train/loss' in r] == [1, 2, 3]
    val = [r for r in rows if 'val/loss' in r]
    assert len(val) == 1 and np.isfinite(val[0]['val/loss'])
    it, n = PT.data_batches(kind, data, 2, 'val', seed=1)
    assert n == (2 if kind == 'pair' else 1)
    first = next(it)
    assert first['tokens'].shape == ((2, C.PAIR_LEN) if kind == 'pair' else (1, C.HEAVY_LEN))
    assert ('chain_type' in first) == (kind == 'pair')


def _records(path):
    store = S.RecordStore(path)
    try:
        return list(store)
    finally:
        store.close()


def test_prebuild_cli_matches_jax(tmp_path, capsys):
    """``python -m hudiff_tpu_torch.data.oas``: the stores the port's
    prebuild subcommands write hold what JAX's write."""
    rows = [('ab1', H1, L1, 'humanized'), ('ab2', H2, L2, 'mouse')]
    _hl_csv(str(tmp_path / 'pairs.csv'), rows)
    (tmp_path / 'p').mkdir()
    (tmp_path / 'j').mkdir()
    outs = []
    for mod, d in ((O, 'p'), (JO, 'j')):
        pair = mod.main(['pair-from-csv', '--csv', str(tmp_path / 'pairs.csv'), '--out',
                         str(tmp_path / d / 'pairs')])
        heavy = mod.main(['heavy', '--data', _heavy_pickle(tmp_path / d / 'heavy.pkl', n=6)])
        outs.append([_records(p) for p in (pair, heavy)])
    assert 'store ready' in capsys.readouterr().out
    assert outs[0] == outs[1] and [len(x) for x in outs[0]] == [2, 6]
