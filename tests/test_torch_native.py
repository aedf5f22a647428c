"""The port's host C++ library (hudiff_tpu_torch/native, built from
hudiff_tpu_torch/csrc/aligner.cc and recordstore.cc) against its plain
versions and the JAX package.

- ``align_to_aho`` / ``align_to_aho_batch`` run the native DP; each must
  give the aligned strings of the JAX package's aligner (native too) and
  of the port's Python DP (``align_to_aho_python``), scores within 1e-4
  relative (the native DP sums in f32, the Python one in f64), on the
  tests' chains and seeded mutants, every profile. Where two paths tie the
  two DPs may break the tie apart: the native path must then score the
  Python DP's optimum in f64 (``chip_smoke.alignment_path_score``).
- ``hd_align_batch`` marks a query that does not embed with -1e30; the
  bridge returns None for it and the others' results are the single calls'.
- ``RecordStore`` reads the same records natively and through mmap, and
  the same as the JAX package's readers.
- A compiler that is missing or fails raises, naming its output; there is
  no fallback.
"""
import numpy as np
import pytest

from hudiff_tpu.data import store as JS
from hudiff_tpu.numbering import align as JAL
from hudiff_tpu_torch import constants as C
from hudiff_tpu_torch import native
from hudiff_tpu_torch.data import store as S
from hudiff_tpu_torch.numbering import _native
from hudiff_tpu_torch.numbering import align as AL

from chip_smoke import alignment_path_score

H1 = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
      'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
L1 = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
      'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
H2 = ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYAMSWVRQAPGKGLEWVSAISGSGGSTYY'
      'ADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAKDRGYYFDYWGQGTLVTVSS')
L2 = ('EIVLTQSPGTLSLSPGERATLSCRASQSVSSSYLAWYQQKPGQAPRLLIYGASSRATGIP'
      'DRFSGSGSGTDFTLTISRLEPEDFAVYYCQQYGSSPLTFGGGTKVEIK')
VHH = ('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADSVKGRF'
       'TISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')
LAMBDA = ('QSALTQPASVSGSPGQSITISCTGTSSDVGGYNYVSWYQQHPGKAPKLMIYEVSNRPSGVSN'
          'RFSGSKSGNTASLTISGLQAEDEADYYCSSYTSSSTLVFGGGTKLTVL')
CHAINS = (H1, L1, H2, L2, VHH, LAMBDA)
PROFILES = ('H', 'K', 'L', 'VHH')
RTOL = 1e-4


def _mutants(n, seed):
    """Seeded variants of the test chains: substitutions, an X, deletions."""
    rs = np.random.RandomState(seed)
    out = []
    for k in range(n):
        s = list(CHAINS[k % len(CHAINS)])
        for i in rs.choice(len(s), 6, replace=False):
            s[i] = C.AA_1[rs.randint(20)]
        s[rs.randint(len(s))] = 'X'
        cut = rs.randint(len(s) - 8)
        del s[cut:cut + rs.randint(0, 8)]
        out.append(''.join(s))
    return out


SEQS = list(CHAINS) + _mutants(12, 0)


def _same(got, ref, profile=None):
    """Equal alignments and scores within RTOL; given ``profile``, a tie
    broken apart also passes (the native path scores the f64 optimum)."""
    if ref is None:
        return got is None
    if got is None or abs(got[1] - ref[1]) > RTOL * abs(ref[1]):
        return False
    return got[0] == ref[0] or (profile is not None and abs(
        alignment_path_score(got[0], profile) - ref[1]) <= RTOL * abs(ref[1]))


@pytest.mark.parametrize('profile', PROFILES)
def test_native_aligner_matches_python_dp_and_jax(profile):
    ties = 0
    for seq in SEQS:
        got = AL.align_to_aho(seq, profile)
        assert got is not None
        assert got == JAL.align_to_aho(seq, profile), seq
        ref = AL.align_to_aho_python(seq, profile)
        assert _same(got, ref, profile), seq
        ties += got[0] != ref[0]
    assert ties <= 2   # a tie is rare: one of 18 chains on the K profile


def test_aligner_rejects_what_it_cannot_embed():
    for seq in ('AC!DE', 'A' * (C.AHO_LEN + 1)):
        assert AL.align_to_aho(seq) is None
        assert AL.align_to_aho_python(seq) is None
        assert JAL.align_to_aho(seq) is None


@pytest.mark.parametrize('profile', PROFILES)
def test_batch_matches_single_calls_and_jax(profile):
    seqs = SEQS + ['', 'BZ' * 10, 'A' * (C.AHO_LEN + 3), SEQS[0]]
    got = AL.align_to_aho_batch(seqs, profile)
    assert got == JAL.align_to_aho_batch(seqs, profile)
    assert got[len(SEQS):len(SEQS) + 3] == [None, None, None]
    for seq, g in zip(SEQS, got):
        assert g == AL.align_to_aho(seq, profile)
        assert _same(g, AL.align_to_aho_python(seq, profile), profile)


def test_batch_marks_a_failure_inside_it():
    """A query longer than the grid fails inside hd_align_batch (-1e30);
    its neighbours keep the single calls' results."""
    score_mat, skip_cost = AL._profile('H')
    good = [AL._query_indices(s) for s in (H1, H2)]
    too_long = [0] * (C.AHO_LEN + 5)
    out = _native.align_batch([good[0], too_long, good[1]], score_mat, skip_cost)
    assert out[1] == (None, float('-inf'))
    assert out[0] == _native.align(good[0], score_mat, skip_cost)
    assert out[2] == _native.align(good[1], score_mat, skip_cost)
    assert _native.align(too_long, score_mat, skip_cost) == (None, float('-inf'))


def test_detection_and_grids_agree_with_jax():
    from hudiff_tpu.numbering import imgt as JIMGT
    from hudiff_tpu_torch.numbering import imgt as IMGT
    for seq in SEQS:
        try:
            want = JAL.detect_chain_type(seq)
        except ValueError:
            with pytest.raises(ValueError):
                AL.detect_chain_type(seq)
            continue
        got = AL.detect_chain_type(seq)
        assert got[:2] == want[:2] and got[2] == pytest.approx(want[2], rel=RTOL)
        heavy = want[0] == 'H'
        g, w = (IMGT.grid_string(seq, heavy=heavy, chain_hint=want[1]),
                JIMGT.grid_string(seq, heavy=heavy, chain_hint=want[1]))
        assert (g is None) == (w is None)
        if g is not None:
            assert g['grid'] == w['grid'] and g['aho'] == w['aho']


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_record_store_native_and_mmap_agree(tmp_path, writer):
    path = str(tmp_path / 'store')
    recs = [{'i': i, 'payload': b'x' * (i * 7 % 23), 'arr': np.arange(i % 9)}
            for i in range(257)]
    with (S if writer == 'port' else JS).RecordStoreWriter(path) as w:
        for r in recs:
            w.put_obj(r)
    readers = [S.RecordStore(path), S.RecordStore(path, native=False),
               JS.RecordStore(path, native=True)]
    assert readers[0]._native is not None and readers[1]._native is None
    for rd in readers:
        assert len(rd) == len(recs)
    for i in range(len(recs)):
        raw = readers[0].get(i)
        assert all(rd.get(i) == raw for rd in readers[1:])
    for got, want in zip(readers[0], recs):
        assert got['i'] == want['i'] and got['payload'] == want['payload']
        np.testing.assert_array_equal(got['arr'], want['arr'])
    with pytest.raises(IndexError):
        readers[0].get(len(recs))
    for rd in readers:
        rd.close()


def test_record_store_empty_and_missing(tmp_path):
    path = str(tmp_path / 'empty')
    S.RecordStoreWriter(path).close()
    for native_reader in (True, False):
        rd = S.RecordStore(path, native=native_reader)
        assert len(rd) == 0 and list(rd) == []
        rd.close()
    with pytest.raises(ValueError, match='not a RecordStore'):
        S.RecordStore(str(tmp_path / 'absent'))


@pytest.mark.parametrize('cxx', ['/nonexistent/bin/c++', 'false'])
def test_a_failed_build_raises(monkeypatch, cxx):
    """No fallback: a compiler that is missing or fails raises, and the
    aligner with it."""
    monkeypatch.setenv('CXX', cxx)
    assert not native.library_path().exists()
    with pytest.raises(RuntimeError, match='C\\+\\+ compiler' if '/' in cxx else 'failed'):
        native.load()
    with pytest.raises(RuntimeError):
        AL.align_to_aho(H1)


def test_library_is_the_ports_own_build():
    lib = native.load()
    path = native.library_path()
    assert path.exists() and path.parent.parts[-2:] == ('build', 'hudiff_tpu_torch')
    assert lib._name == str(path)
    assert native.load() is lib
