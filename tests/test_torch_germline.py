"""The port's germline library, CDR grafting and region labels
(hudiff_tpu_torch/numbering/{germline,regions}.py) against the JAX
package's, on the CPU.

Both modules are copies, so everything is held exactly: the library
tables, the gridded library, graft grids, nearest V/J names, the
cdr_pair_grafting strings, region labels; the V-gene identity scores to
1e-12. The chains: the mouse and human test pairs of tests/test_germline.py
and tests/test_torch_humanize.py, two lambda chains built from the library,
a chain that does not align (cdr_pair_grafting raises in both) and a chain
whose group library is emptied (graft_cdrs raises in both).
"""
import numpy as np
import pytest

from hudiff_tpu.numbering import germline as JG
from hudiff_tpu.numbering import regions as JR
from hudiff_tpu_torch.numbering import germline as G
from hudiff_tpu_torch.numbering import imgt as IMGT
from hudiff_tpu_torch.numbering import regions as R

MOUSE_H = ('QVQLQQPGAELVKPGASVKLSCKASGYTFTSYWMHWVKQRPGQGLEWIGEINPSNGRTNY'
           'NEKFKSKATLTVDKSSSTAYMQLSSLTSEDSAVYYCARGGYYFDYWGQGTTLTVSS')
MOUSE_L = ('DIVMTQSQKFMSTSVGDRVSVTCKASQNVGTNVAWYQQKPGQSPKALIYSASYRYSGVPD'
           'RFTGSGSGTDFTLTISNVQSEDLAEYFCQQYNSYPLTFGAGTKLELK')
HUMAN_H = ('EVQLVESGGGLVQPGGSLRLSCAASGFTFSSYAMSWVRQAPGKGLEWVSAISGSGGSTYY'
           'ADSVKGRFTISRDNSKNTLYLQMNSLRAEDTAVYYCAKDRGYYFDYWGQGTLVTVSS')
HUMAN_L = ('EIVLTQSPGTLSLSPGERATLSCRASQSVSSSYLAWYQQKPGQAPRLLIYGASSRATGIP'
           'DRFSGSGSGTDFTLTISRLEPEDFAVYYCQQYGSSPLTFGGGTKVEIK')
LAMBDA1 = JG.GERMLINE_V_LAMBDA['IGLV1-40*01'] + 'SLSGVV' + JG.GERMLINE_J_LAMBDA['IGLJ2*01']
LAMBDA2 = JG.GERMLINE_V_LAMBDA['IGLV2-14*01'] + 'SSYFGGTKLTVL'
VHH = ('QVQLVESGGGLVQAGGSLRLSCAASGRTFSSYAMGWFRQAPGKEREFVAAISWSGGSTYYADSVKGRF'
       'TISRDNAKNTVYLQMNSLKPEDTAVYYCAADRGSYYYTRNQYDYWGQGTQVTVSS')
PAIRS = [(MOUSE_H, MOUSE_L), (HUMAN_H, HUMAN_L), (MOUSE_H, LAMBDA1), (HUMAN_H, LAMBDA2)]
CHAINS = [(MOUSE_H, 'H'), (HUMAN_H, 'H'), (MOUSE_L, 'K'), (HUMAN_L, 'K'),
          (LAMBDA1, 'L'), (LAMBDA2, 'L'), (VHH, 'H')]
TABLES = ('GERMLINE_V_HEAVY', 'GERMLINE_V_KAPPA', 'GERMLINE_V_LAMBDA', 'GERMLINE_J_HEAVY',
          'GERMLINE_J_KAPPA', 'GERMLINE_J_LAMBDA', '_FR4_LEN', '_CHAIN_CONTEXT')


@pytest.fixture
def libraries(monkeypatch):
    """Both packages' V libraries as copies, with empty grid caches, so that
    a test may change them."""
    for mod in (G, JG):
        for group, lib in list(mod._V_BY_GROUP.items()):
            monkeypatch.setitem(mod._V_BY_GROUP, group, dict(lib))
        monkeypatch.setattr(mod, '_GRID_CACHE', {})
    return G, JG


@pytest.mark.parametrize('name', TABLES)
def test_library_tables_are_equal(name):
    assert getattr(G, name) == getattr(JG, name)


@pytest.mark.parametrize('group', ['H', 'K', 'L'])
def test_gridded_library_is_equal(group):
    ours, theirs = G._gridded_library(group), JG._gridded_library(group)
    assert list(ours) == list(theirs)
    for name in theirs:
        np.testing.assert_array_equal(ours[name], theirs[name], err_msg=name)


def _grid(seq, group):
    return np.asarray(list(IMGT.grid_string(seq, heavy=group == 'H', chain_hint=group)['grid']))


@pytest.mark.parametrize('seq,group', CHAINS)
def test_scores_nearest_genes_and_grafts_are_equal(seq, group):
    grid = _grid(seq, group)
    ours, theirs = G.v_gene_scores(grid, group), JG.v_gene_scores(grid, group)
    assert list(ours) == list(theirs)
    np.testing.assert_allclose([ours[k] for k in theirs], list(theirs.values()),
                               rtol=0, atol=1e-12)
    assert G.gene_scores(grid, group) == pytest.approx(JG.gene_scores(grid, group),
                                                       abs=1e-12)
    assert G.nearest_v(grid, group)[0] == JG.nearest_v(grid, group)[0]
    assert G.nearest_j(grid, group) == JG.nearest_j(grid, group)
    for back in (False, True):
        ours, theirs = G.graft_cdrs(grid, group, back), JG.graft_cdrs(grid, group, back)
        np.testing.assert_array_equal(ours['grid'], theirs['grid'])
        assert (ours['v_gene'], ours['j_gene']) == (theirs['v_gene'], theirs['j_gene'])
    assert G.fr_identity_grid(grid, group) == JG.fr_identity_grid(grid, group)
    assert G.germline_fr_identity(seq, group) == JG.germline_fr_identity(seq, group)
    assert G.germline_fr_identity(seq) == JG.germline_fr_identity(seq)


@pytest.mark.parametrize('seq', [MOUSE_H, MOUSE_L, LAMBDA1])
def test_graft_seq_is_equal(seq):
    ours, theirs = G.graft_seq(seq), JG.graft_seq(seq)
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        else:
            assert ours[key] == value, key


@pytest.mark.parametrize('back_mutation', [False, True])
@pytest.mark.parametrize('pair', PAIRS, ids=['mouse', 'human', 'lambda1', 'lambda2'])
def test_cdr_pair_grafting_is_equal(pair, back_mutation):
    assert (G.cdr_pair_grafting(*pair, back_mutation=back_mutation)
            == JG.cdr_pair_grafting(*pair, back_mutation=back_mutation))


@pytest.mark.parametrize('pair', [('AAAAGGGG', MOUSE_L), (MOUSE_H, 'GGGG')])
def test_unalignable_chain_raises_in_both(pair):
    with pytest.raises(ValueError) as ours:
        G.cdr_pair_grafting(*pair)
    with pytest.raises(ValueError) as theirs:
        JG.cdr_pair_grafting(*pair)
    assert str(ours.value) == str(theirs.value)


def test_graft_raises_in_both_on_an_empty_library(libraries):
    grid = _grid(MOUSE_L, 'K')
    for mod in libraries:
        mod._V_BY_GROUP['K'].clear()
    with pytest.raises(ValueError, match='no germline aligned for group K'):
        G.graft_cdrs(grid, 'K')
    with pytest.raises(ValueError, match='no germline aligned for group K'):
        JG.graft_cdrs(grid, 'K')


def _fasta(path):
    heavy = JG.GERMLINE_V_HEAVY['IGHV3-23*01']
    kappa = JG.GERMLINE_V_KAPPA['IGKV1-39*01']
    with open(path, 'w') as f:
        # IMGT/GENE-DB headers: a new functional allele (gaps stripped), one
        # annotated '[F]', a pseudogene, an ORF and a D gene (skipped)
        f.write('>X1|IGHV3-23*05|Homo sapiens|F|V-REGION|\n'
                + heavy[:20] + '..' + heavy[20:40].replace('S', 'T', 1) + '\n' + heavy[40:] + '\n')
        f.write('>X2|IGKV1-39*02|Homo sapiens|[F]|V-REGION|\n' + kappa.replace('Q', 'E', 1) + '\n')
        f.write('>X3|IGHV3-23*06|Homo sapiens|P|V-REGION|\n' + heavy + '\n')
        f.write('>X4|IGLV1-40*09|Homo sapiens|ORF|V-REGION|\n'
                + JG.GERMLINE_V_LAMBDA['IGLV1-40*01'] + '\n')
        f.write('>X5|IGHD1-1*01|Homo sapiens|F|D-REGION|\nGTTGT\n')
        # plain headers: a new allele, a duplicate name, one that does not place
        f.write('>IGLV2-14*09 plain\n' + JG.GERMLINE_V_LAMBDA['IGLV2-14*01'].lower() + '\n')
        f.write('>IGHV3-23*01\n' + heavy + '\n')
        f.write('>IGKV9-99*01\nAAAAAAAAGGGGGGGG\n')


def test_extend_library_from_fasta_adds_the_same_entries(libraries, tmp_path):
    path = tmp_path / 'germline.fasta'
    _fasta(path)
    before = {g: set(lib) for g, lib in G._V_BY_GROUP.items()}
    added = G.extend_library_from_fasta(str(path))
    assert added == JG.extend_library_from_fasta(str(path)) == 3
    assert G._V_BY_GROUP == JG._V_BY_GROUP
    assert {g: set(lib) - before[g] for g, lib in G._V_BY_GROUP.items()} == {
        'H': {'IGHV3-23*05'}, 'K': {'IGKV1-39*02'}, 'L': {'IGLV2-14*09'}}
    grid = _grid(MOUSE_H, 'H')
    assert G.v_gene_scores(grid, 'H') == JG.v_gene_scores(grid, 'H')


def test_env_fasta_is_loaded_before_first_use(libraries, tmp_path, monkeypatch):
    path = tmp_path / 'germline.fasta'
    _fasta(path)
    monkeypatch.setenv('HUDIFF_GERMLINE_FASTA', str(path))
    for mod in libraries:
        monkeypatch.setattr(mod, '_ENV_FASTA_LOADED', False)
        assert 'IGKV1-39*02' in mod._gridded_library('K')
    assert G._V_BY_GROUP == JG._V_BY_GROUP


@pytest.mark.parametrize('seq,heavy,hint', [(MOUSE_H, True, 'H'), (HUMAN_L, False, 'K'),
                                            (LAMBDA1, False, 'L'), (VHH, True, 'VHH'),
                                            (MOUSE_L, False, None), ('GGGG', True, None)])
def test_regions_are_equal(seq, heavy, hint):
    assert R.get_regions(seq, heavy, hint) == JR.get_regions(seq, heavy, hint)
    assert (R.region_sequences(seq, heavy, hint)
            == JR.region_sequences(seq, heavy, hint))
